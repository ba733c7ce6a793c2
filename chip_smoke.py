"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero and prints no result line):
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles the port's CUDA kernels from ``tstar_tpu_torch/csrc``;
     the bf16 attention kernels (K1, K8: ``attn_sm90_kernel``), the bf16
     patch-embed GEMM (K2: ``patch_embed_sm90_kernel``), LayerNorm->matmul
     (K5: ``ln_matmul_kernel``) and cache->patch embeddings (K6:
     ``grid_embed_sm90_kernel``) must hold ``HGMMA`` (wgmma) and ``UTMALDG``
     (TMA load) instructions in the library's SASS (``cuobjdump -sass``) and
     spill no register (ptxas), the int8 GEMM (K4: ``w8a8_kernel``)
     ``IGMMA`` (integer wgmma) and ``UTMALDG`` with no spills; K3's
     (``layernorm_kernel``) and K7's (``grid_pack_kernel``) registers and
     spills are printed, and the grids K2, K4, K5, K6 and the attention
     kernel take at the main shapes;
  3. kernels: each hand-written kernel (K1 attention, K2 patch embed, K3
     LayerNorm, K4 W8A8 matmul, K5 LayerNorm->matmul, K6 cache->patch
     embeddings, K7 grid pack, K8 flash attention) against its plain
     PyTorch version at the main paths' shapes, with the max abs error, its
     tolerance (K4: exactly equal), CUDA-event times of kernel, plain
     version and the one PyTorch call that computes the same function where
     there is one (``library_ms``; K4-K7 have none and get yardsticks that
     do part of the work), and the bound the card sets for the same work;
     then the decode kernels D1-D3, Kimi-VL's MoE router and experts
     M1-M2 and its latent attention (MLA) at their decode shapes, timed
     inside CUDA graphs;
  4. tower numerics: one 768^2 grid image through the full-width OWL-ViT B/32
     (seeded random weights) in bf16 on the card with the kernels, against
     the same weights in f32 on the CPU with the plain versions;
  4b. int8 tower numerics: the same image through the int8 tower in bf16 on
     the card (K4), against the bf16 tower on the card (per-patch feature
     cosine) and the same int8 tower in f32 on the CPU (scores);
  5. the slice: ``initialize_heuristic('owl-vit-random')`` in bf16 on the card,
     ``KeyframeSearcher.search()`` over a synthetic 600 s video; K1, K2 and
     K3 must launch during the search;
  4c. grid-input and attention routes in the tower: the phase-4 grid's
     embeddings through K6 and ``encode_patches``, and the phase-4 image with
     ``TSTAR_FUSED_MHA=0 TSTAR_FLASH_ATTENTION=1`` (K8), each against the CPU
     f32 pixel chain of phase 4;
  4d. widths: an encoder layer at SigLIP's D = 1152, 16 heads x 72 on the
     card in bf16 and f32 against the same layer on the CPU, launching K3
     for its two LayerNorms (1152 = 9 x 128, as the reference's kernel takes
     it) and no K1 (heads of 72 take the split-head route, the reference's
     XLA); the phase-4 B/32 towers launch K3 for every LayerNorm and K1 for
     every unbiased attention;
  6. the detector knobs on the same search: ``detector_quant='int8'`` with
     ``verify_image_size=512`` (K4; every launch must read one of the 48
     (N, K) weight copies made once for the scorer: no weight is transposed
     per call), ``detector_quant='w8a16'``, and the bf16 tower with
     ``TSTAR_LN_MATMUL=force`` (K5);
  7. the grid-input and attention routes on the same search:
     ``use_pallas_preprocess=True`` (K7 once per grid forward),
     ``TSTAR_GRID_EMBED=force`` (K6 once per grid forward, K2 only in
     verification) and ``TSTAR_FUSED_MHA=0 TSTAR_FLASH_ATTENTION=1`` (K8 12
     times per forward, K1 never); then K6's route traced through K6 and
     through its plain version on the card, to show how far K6's summation
     order moves the search (the grid forwards that sampled the same
     seconds and their largest score difference, the verification batches
     and keyframes of each); ``triton`` must not have been imported.
  8. the batched multi-video search: ``search_videos`` over eight distinct
     synthetic 600 s videos (8 x 141.6 MB of caches) at B = 8 in bf16,
     stepped through CUDA graphs: each video's seconds per iteration,
     keyframes, iterations and remaining targets equal to the same search
     with ``graphs=False``; one video's ``run_search`` with graphs equal to
     ``run_search(graphs=False)``; each video's first grid confidences in
     the batch within phase 4's 2e-2 of its single-video grid forward; no
     synchronization in an eager grid step and verification rounds under
     ``torch.cuda.set_sync_debug_mode("error")`` (the driver's two reads a
     step aside); and under ``TSTAR_GRID_EMBED=1`` K6's gate opens at the
     batch of 8 (K6 once per grid forward, K2 only in verification).
  9. the VLM stages (grounding and QA): (a) LLaVA-OneVision at 7B's widths
     (SigLIP so400m 1152 x 27, Qwen2-7B 3584 x 28, vocabulary 152064; 8.0 B
     parameters seeded on the card in bf16) answers one multiple-choice
     question over 8 frames of a synthetic video through
     ``prepare_llava_inputs`` -> ``generate`` (30 new tokens, greedy),
     decoding through a CUDA graph and eagerly (equal tokens); a second
     request of the same bucket captures nothing; K3 launches 54 times a
     request (two LayerNorms in each of SigLIP's 27 layers) and no other
     kernel; a decode replay raises nothing under the sync debug mode;
     SigLIP, prefill and decode times beside their data-sheet bounds, the
     request's seconds and peak memory; (b) at full widths and reduced depth
     (2 + 2 layers, 2 frames) LLaVA-OneVision's and Qwen2-VL's next-token
     logits in bf16 on the card against the same weights in f32 on the CPU;
     (c) a tiny checkpoint of each family written by this script, loaded
     through ``UniversalGrounder`` on the card and on the CPU in f32: equal
     QA, grounding and batched QA strings at temperature 0.
  10. YOLO-World and the checkpoints: (a) the class-aware NMS kernel
     (``csrc/nms.cu``) against its plain version at N = 8,400 anchors, 80
     classes, tied scores, B = 1 and 8 (one image all below the score
     threshold) and with as many slots as boxes: ``keep`` and ``valid``
     equal, then ``postprocess_yolo`` through each (equal at the valid
     slots), the kernel's time, plain time and bound, its registers and
     spills; (b) ``initialize_heuristic('yolo-world-random', size='xl')``
     (72,886,361 + 63,396,864 parameters) in bf16, its folded BN scales set
     for unit variance on the scene (``profile_search.calibrated_yolo_xl``:
     at the seeded init every anchor scores 0.5000 and every class and NMS
     decision is a tie): the forward at B = 1 and
     8 beside its bound, then ``KeyframeSearcher`` on the synthetic 600 s
     video stepped through graphs equal to the eager search, K3 25 times a
     search (the prompts' text encode, counted from the scorer's build), the
     NMS kernel once a forward and no other kernel; (c) ``search_videos``
     over ``scene_variant(0..7)`` in one bucket of B = 8, each video's
     keyframes and iterations against its single-video search in bf16
     (where they part, the script says how many, shows the cause by
     counting the convolutions whose bits for one image depend on the
     batch, and then holds the batched search to the single ones in f32;
     a difference the convolutions do not explain fails); (d) ``yoloworld_small`` bf16 on the card against
     f32 on the CPU within a derived tolerance, then the small search in f32
     with replayed noise, card against CPU, the same keyframes; (e) an
     mmyolo ``.pth`` of the XL model and an HF OWL-ViT B/32 directory,
     written here with CLIP vocabulary files, loaded through
     ``initialize_heuristic('yolo-world' | 'owl-vit', checkpoint_dir=...)``:
     outputs equal to the written model's, the OWL-ViT search equal to
     ``owl-vit-random``'s with the same weights and tokenizer.
  11. the T* pipeline end to end: (a) ``TStarFramework.run()`` (grounding,
     search with its history, QA) on the synthetic 600 s video with
     ``owl-vit-random`` B/32 in bf16 and phase 9a's 7B-wide LLaVA-OneVision,
     run twice (the first captures); the grounding request runs at the
     framework's 512-token cap and its answer is replaced by the scene's two
     lines (seeded weights cannot name the objects), the QA request is the
     model's own at temperature 0; the keyframes equal a plain ``search()``, one history row
     and two host reads a search step, K1 / K2 / K3 launches per grid and
     verify forward as phase 5's plus K3 for the prompts' text encode and
     54 in each VLM request, the answer equal to ``inference_qa`` at
     temperature 0 on the keyframes; each stage's seconds and the peak
     memory, split into what was allocated as ``run()`` began and the peak
     above it; (b) the same with phase 10's YOLO-World v2-XL (NMS once a
     forward, K3 only in the text encode and the VLM), its detection history
     NMS's kept set, run before (a) so that the XL model is freed before the
     OWL-ViT pipeline's run; (c) a tiny
     f32 pipeline (phase 9c's tiny LLaVA-OneVision checkpoint through
     ``UniversalGrounder(model_path=)``, a tiny ``owl-vit-random``), card
     against CPU on the same replayed noise: the same grounding (or parse
     error), timestamps and answer; (d) ``search_videos(collect_history=True)``
     over phase 8's bucket of 8: the keyframes without history, two host
     reads a step, each row's history its video's steps.
  12. the streaming search and reference-fidelity verification, on
     ``owl-vit-random`` B/32 in bf16: (a) phase 5's 600 s scene searched with
     ``cache_mode='streaming'`` (each step's sampled seconds decoded on the
     host and copied into the scorer's step buffer) and resident, both
     through graphs: the same keyframes and iterations, ``P`` bitwise equal,
     phase 5's launches (K1 12, K2 1, K3 27 a forward), three host reads a
     step; the wall, the host milliseconds a step spends decoding and
     uploading, and (``tools/profile_search.py`` in a process of its own)
     each search's device-busy share; (b) the 4-hour scene (14,400 s) under
     ``cache_mode='auto'`` streams, its peak memory above what the search
     began with at most the 600 s streaming search's plus 256 B a further
     padded second, and under 0.5 GB, beside the 3.2 GB a resident cache
     would take,
     then ``search_videos`` over it and three shorter videos with a 2 GB
     device total: exactly it streams, and every row equals that video's
     single search; (c) ``run_search_reference_verify`` on the 600 s scene,
     its raw 360x640 frames resized to 285x600 by ``make_raw_frame_source``:
     the graphed run's decisions and keyframes equal the eager run's, the
     tower's launches per forward.  The file decoder is not exercised on the
     card: its machine has no FFmpeg (``native/libtstar_video.so`` does not
     load, ``native/video_decoder.cpp`` does not build there).
  13. the calibrated detector and its A/B tools, Qwen2.5-VL, anyres: (a)
     ``initialize_heuristic('owl-vit-calibrated')`` at B/32's full width,
     calibrated (couch, lamp, tv) in f32 on the card and on the host's
     CPU with the same weights: every direction's cosine >= 0.9999 and every
     calibration statistic within a tolerance derived from the class head's
     per-patch scale and the directions' difference; then phase 5's search
     in bf16 with the calibrated scorer (K1 12, K2 1, K3 27 a forward, two
     host reads a step), its margins printed (random weights at these
     widths need not separate the objects); (b) ``tools/ab_knob_recall.py
     --scenes 2 --seeds 2`` in a process of its own: its JSON line and each
     knob's launches, then the lottery's seed calibrated here on the card
     and on the CPU (the same directions and margins); (c) ``tools/verify_ab.py --videos 2``: the cache-row
     verification against the raw 285x600 chain; (d) a tiny f32 Qwen2.5-VL
     checkpoint written here, loaded through ``UniversalGrounder`` on the
     card and on the CPU: the same QA, grounding and batched strings at
     temperature 0, as phase 9c; (e) one QA request at
     Qwen2.5-VL-7B-Instruct's published widths (8.3 B parameters seeded on
     the card in bf16): prefill ms, decode ms a token beside its bound, peak
     memory, no port kernel; (f) ``encode_anyres_image`` at phase 9a's
     SigLIP widths on a 3x3-tile image: bf16 with K3 (54 launches) against
     the f32 run with K3's plain version on the card.
  14. the multi-device layer (``parallel/mesh.py``, ``parallel/shardings.py``):
     (a) a one-rank NCCL mesh: phase 8's bucket of 8 (B/32, bf16) through
     ``search_videos`` without a mesh, with ``mesh=make_mesh(1, 1)`` and with
     the detector ``shard_module``d at model = 1 (its row-parallel layers
     all-reduce inside the captured step graphs): equal keyframes and
     iterations, the same graph replays and host reads a step, the same
     launches; then two ranks spawned on cuda:0 over gloo (NCCL refuses two
     ranks on one device), each against one-process runs made first: (b) data
     = 2, model = 1: the 8 videos, 4 a rank, in f32 with TF32 off, equal to
     the one-process bucket, steps still graphed (no collective in a step);
     the bf16 agreement with phase 8's bucket and the first grid forward's
     difference between a bucket of 4 and of 8 in bf16 and f32 (the cause of
     a difference); (c) data = 1, model = 2: B/32's grid forward at full
     width, 6 heads a rank (K1 12 times a forward), within phase 4's 2e-2 of
     the whole model; searches of 2 videos in f32 (keyframes equal to one
     rank's) and bf16 (counted launches: K1 12 and K3 27 a forward), eager
     (a gloo model group cannot be captured), their walls; (d) model = 2:
     LLaVA-OneVision at 7B widths, the LM cut to ``TP_LM_LAYERS`` = 4 of 28
     layers: phase 9a's request, greedy f32 tokens equal to one rank's, bf16
     next-token logits within 2e-2 relative L2, a sampled request
     (temperature 0.7, seed 5) the same on both ranks, prefill and decode
     times under gloo (staged through the host), each rank's peak memory.
  15. the quantized detector on a tensor-parallel mesh and the
     reference-style baseline: (a) a one-rank NCCL mesh: phase 8's bucket
     of 8 under phase 6's int8 + verify 512 through ``search_videos``
     without a mesh and with the detector ``shard_module``d at model = 1
     (the int8 tower sharded alike: out_proj and fc2 on K4's row-parallel
     mode, their MAX and SUM all-reduces inside the captured graphs): equal
     keyframes and iterations, K4's launches equal (24 column + 24
     row-parallel a forward against 48), two host reads a step; (b) two
     gloo ranks on cuda:0 at model = 2 (B/32 bf16, 6 heads a rank): the
     int8 tower's features on one grid image against the whole int8
     tower's, bit for bit (else the layer where they part, allowed only
     where K1's local heads alone explain it), K4 24 column and 12
     row-parallel launches a forward (out_proj's (384, 768) shard in plain
     ops); an int8 + verify 512 search of 2 videos in bf16 (launches by
     mode; keyframes printed beside one rank's, with the first grid
     forward's difference), and the same search in f32 and under w8a16 in
     f32, each held to one rank's step by step (keyframes equal, or parted
     only at a witnessed tie of the sampler; the first grid forward within
     1e-4: phase 14c's tolerances);
     (c) ``bench/reference_style.reference_style_search`` (the original
     TStar's host loop) with a B/32 bf16 forward at 768^2 on phase 5's
     600 s video: frames scored, wall, frames/s, K1 / K2 / K3 launches a
     forward, its host grid within one level of the device grid builder's.
  16. Kimi-VL-A3B-Instruct at its published widths, seeded on the card in
     bf16: two grounding requests (8 frames of 360 x 640 at native
     resolution, the 512-token cap, temperature 0) through
     ``TorchVLMBackend.from_model`` -> ``generate``, the first capturing
     its bucket, the second only replaying: the router (M1) and expert (M2)
     kernels launched 26 times a decode step in each and the latent
     attention (MLA) 27 times, one step's ``step_launches`` 26 and 27, at most
     300 kernel launches a step (its graph's kernel nodes), a replay under
     ``set_sync_debug_mode('error')``; the expert_tokens skew.
In phases 5-8 every kernel's launches must equal its launches per grid and
per verification forward times those forwards (a CUDA graph's replay counts
the launches its capture recorded), and the searches step through graphs
with two host reads a step.
Phase 3 also runs K1 at a tensor-parallel rank's local heads of B/32 (6 and 3
heads, B = 1 and 8), K5 at the local widths it takes (N = 1152, 1536,
768) and K4's row-parallel mode at fc2's shards (1536 and 768 -> 768, R =
577 and 8 x 577; exact).  The second-to-last line is a JSON object of per-kernel results (K1-K8
with their launches in phase 10b's YOLO search, in phase 11's pipelines, in
phase 12a's streaming search, in phase 13a's calibrated search, 13f's
anyres encode and 13b's knob A/B, in 14a's sharded search and 14c's TP
search, in 15a's sharded int8 bucket and 15b's int8 TP search, K1's and
K5's local-width rows, K4's row-parallel rows and launches, D1-D3 and
M1-M2 and MLA with their launches a decode step (phase 16's two requests),
and the NMS kernel); the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

# NVIDIA H100 SXM, dense peaks from NVIDIA's data sheet: device memory rate,
# tensor-core bf16 and int8 rates, and f32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


KERNELS = ("fused_mha_from_qkv", "patch_embed_matmul", "fused_layernorm", "w8a8_matmul",
           "ln_matmul", "grid_cell_embed", "build_detector_grid_pallas", "flash_mha",
           "greedy_nms")


# The decode step's kernels (kernels/decode.py): each fused decoder layer
# launches add_rms_norm twice and the others once; the final norm once more.
DECODE_KERNELS = ("add_rms_norm", "decode_attention", "silu_mul")


def decode_launches(counts, steps: int, layers: int = 28) -> bool:
    """Whether ``counts`` hold the decode kernels' launches of ``steps``
    decode steps with all ``layers`` layers on the fused route."""
    want = {"add_rms_norm": (2 * layers + 1) * steps, "decode_attention": layers * steps,
            "silu_mul": layers * steps}
    return {k: counts[k] for k in DECODE_KERNELS} == want


def fused_layers(stats) -> int:
    """A decode step's layers on the Qwen2 decode kernels: one
    ``decode_attention`` launch each (``GenerateStats.step_launches``)."""
    return stats.step_launches.get("decode_attention", 0)


def launches(**per_forward):
    """Every kernel's launches per detector forward, 0 where not named; a
    value is a count for every forward or (per grid, per verify) forward."""
    return {k: per_forward.get(k, 0) for k in KERNELS}


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


def graph_ms(fn, calls: int = 50, replays: int = 10) -> float:
    """Mean device milliseconds per call of ``fn`` captured ``calls`` times
    into one CUDA graph: a call's launch inside a graph, as the decode step
    replays it, without the host's launch rate between eager calls."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                  # the first call, eagerly
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(3):
        graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def bound_ms(n_bytes: float, n_ops: float, kind: str):
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the memory rate
    and the operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass
class Case:
    """One kernel call at one shape, with what it is held and timed against."""

    kernel: str
    shape: str
    dtype: str
    run: Callable            # the kernel's wrapper on card tensors
    plain: Callable          # its plain PyTorch version, same inputs
    check: Callable          # (got, plain result) -> (max abs err, ok, tolerance text)
    n_bytes: float
    n_ops: float
    kind: str                # operand type of the operations: bf16 / int8 / f32
    library: Optional[Callable] = None      # one PyTorch call, same function
    yardsticks: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    graphed: bool = False    # timed inside a CUDA graph (graph_ms), as its path replays it


def _close(atol, rtol, ref=None):
    """Pass when |got - want| <= atol + rtol * |want| everywhere (``ref``
    replaces the plain version as the reference when given)."""
    def check(got, want, x=None):
        want = (ref(x) if ref is not None else want).float()
        diff = (got.float() - want).abs()
        ok = bool((diff <= atol + rtol * want.abs()).all()) and bool(got.float().isfinite().all())
        return diff.max().item(), ok, f"atol {atol:.0e} + rtol {rtol:.2e}*|ref|"
    return check


def kernel_cases(torch):
    """Phase 3's cases: every kernel at every shape the main paths give it."""
    from torch.nn import functional as F

    from tstar_tpu_torch.kernels import (
        attention, grid_embed, layernorm, ln_matmul, pallas_grid, patch_matmul, quant_matmul,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    names = {bf16: "bf16", f32: "f32"}
    # bf16: the f32 results before the final rounding differ by summation
    # order only (~1e-6 relative), so the outputs differ by at most one bf16
    # ulp, which rtol = 2^-7 covers; K1's and K8's atol also covers a rounding
    # flip of one of their bf16 probabilities (both round where their
    # reference does).  f32: summation order only.
    bf16_ulp = 2.0 ** -7
    tols = {
        "K1": {bf16: (1e-3, bf16_ulp), f32: (1e-6, 1e-5)},
        "K2": {bf16: (1e-4, bf16_ulp), f32: (1e-4, 1e-5)},
        "K3": {bf16: (1e-5, bf16_ulp), f32: (1e-5, 1e-5)},
        # K7: the same 2-4 tap products, summed in another order, rounded once.
        "K7": {bf16: (1e-6, bf16_ulp), f32: (1e-5, 1e-5)},
        "K8": {bf16: (1e-3, bf16_ulp), f32: (1e-5, 1e-5)},
    }
    cases = []

    # K1.  B=1: the grid forward; 8 / 16: the bucketed / wide verify forwards;
    # S=257: verification at 512 pixels.  S=385 keeps even f32 K/V resident
    # in shared memory (the branch bf16 takes at S=577); f32 at S=577 takes
    # the tiled branch.
    for b, s in ((1, 577), (8, 577), (16, 577), (16, 257), (2, 385)):
        base = torch.randn(b, s, 3 * 768, generator=g, device=dev)
        for dt in (bf16, f32):
            qkv = base.to(dt)
            q, k, v = (qkv[..., i * 768:(i + 1) * 768].view(b, s, 12, 64).transpose(1, 2)
                       for i in range(3))
            es = qkv.element_size()
            cases.append(Case(
                "K1", f"B={b} S={s} 12x64", names[dt],
                run=lambda qkv=qkv: attention.fused_mha_from_qkv(qkv, 12),
                plain=lambda qkv=qkv: attention.fused_mha_from_qkv_plain(qkv, 12),
                check=_close(*tols["K1"][dt]),
                n_bytes=qkv.numel() * es + b * s * 768 * es, n_ops=4 * b * 12 * s * s * 64,
                kind=names[dt],
                library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v),
            ))

    # K2.  768^2 grid and verify images, 512^2 verification images; bf16 also
    # at B=3 (72 patch rows: a ragged last tile of the wgmma kernel).
    w32 = torch.randn(32, 32, 3, 768, generator=g, device=dev) * 0.02
    for b, hw in ((1, 768), (8, 768), (16, 768), (8, 512), (16, 512), (3, 768)):
        base = torch.randn(b, hw, hw, 3, generator=g, device=dev)
        for dt in (bf16, f32) if b != 3 else (bf16,):
            px, w = base.to(dt), w32.to(dt)
            x_nchw = px.permute(0, 3, 1, 2)            # a channels-last view
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            es = px.element_size()
            p = (hw // 32) ** 2

            def ref(x, px=px, w=w):
                # the plain version in f32 on the same (rounded) inputs,
                # rounded once: cuBLAS's bf16 GEMM may reduce in bf16
                return patch_matmul.patch_embed_matmul_plain(px.float(), w.float()).to(px.dtype)

            cases.append(Case(
                "K2", f"B={b} {hw}x{hw}x3->768", names[dt],
                run=lambda px=px, w=w: patch_matmul.patch_embed_matmul(px, w),
                plain=lambda px=px, w=w: patch_matmul.patch_embed_matmul_plain(px, w),
                check=_close(*tols["K2"][dt], ref=ref),
                n_bytes=(px.numel() + w.numel() + b * p * 768) * es,
                n_ops=2 * b * p * 3072 * 768, kind=names[dt],
                library=lambda x=x_nchw, w=w_oihw: torch.nn.functional.conv2d(x, w, stride=32),
            ))
    # K2 at patch 16 (the B/16 detectors' 48-value (pw, c) runs: 16-value TMA
    # segments), one 768^2 image; its own generator keeps the inputs of the
    # other cases as they were.
    g16 = torch.Generator(device=dev).manual_seed(16)
    px16 = torch.randn(1, 768, 768, 3, generator=g16, device=dev).to(bf16)
    w16 = (torch.randn(16, 16, 3, 768, generator=g16, device=dev) * 0.02).to(bf16)
    cases.append(Case(
        "K2", "B=1 768x768x3->768 patch 16", "bf16",
        run=lambda: patch_matmul.patch_embed_matmul(px16, w16),
        plain=lambda: patch_matmul.patch_embed_matmul_plain(px16, w16),
        check=_close(*tols["K2"][bf16], ref=lambda x: patch_matmul.patch_embed_matmul_plain(
            px16.float(), w16.float()).to(bf16)),
        n_bytes=(px16.numel() + w16.numel() + 48 * 48 * 768) * 2,
        n_ops=2 * 48 * 48 * 768 * 768, kind="bf16",
        library=lambda x=px16.permute(0, 3, 1, 2), w=w16.permute(3, 2, 0, 1).contiguous():
            torch.nn.functional.conv2d(x, w, stride=16),
    ))

    # K3.  577 / 8x577 / 16x577 rows of the vision tower, 256 of the text
    # tower, 2 x 37 of phase 4d's SigLIP-width layer and 8 x 729 of phase
    # 9's SigLIP over eight frames (rows read twice in bf16); scale and bias
    # in x's dtype, as the towers hold them.
    for rows, d in ((577, 768), (8 * 577, 768), (16 * 577, 768), (256, 512), (74, 1152),
                    (8 * 729, 1152)):
        base = torch.randn(rows, d, generator=g, device=dev) * 3 + 1
        s = torch.randn(d, generator=g, device=dev)
        bias = torch.randn(d, generator=g, device=dev)
        for dt in (bf16, f32):
            x = base.to(dt)
            s_dt, b_dt = s.to(dt), bias.to(dt)
            es = x.element_size()
            cases.append(Case(
                "K3", f"{rows}x{d}", names[dt],
                run=lambda x=x, s_dt=s_dt, b_dt=b_dt: layernorm.fused_layernorm(x, s_dt, b_dt),
                plain=lambda x=x, s_dt=s_dt, b_dt=b_dt: layernorm.fused_layernorm_plain(x, s_dt, b_dt),
                check=_close(*tols["K3"][dt]),
                n_bytes=2 * rows * d * es + 2 * d * es, n_ops=8 * rows * d, kind=names[dt],
                library=lambda x=x, d=d, s_dt=s_dt, b_dt=b_dt: F.layer_norm(x, (d,), s_dt, b_dt, 1e-5),
            ))

    # K4.  The int8 tower's four dense layers at R = 577 (grid), 16 x 257
    # (verify at 512) and 16 x 577 (wide verify).  Exactly equal.  The kernel
    # reads the weight's (N, K) copy, made once here as the tower makes it
    # once per scorer.
    def exact(got, want, x=None):
        return (got.float() - want.float()).abs().max().item(), bool(torch.equal(got, want)), "exact"

    layers = (("qkv", 768, 2304, f32, bf16), ("out_proj", 768, 768, bf16, bf16),
              ("fc1", 768, 3072, f32, f32), ("fc2", 3072, 768, f32, bf16))
    for rows in (577, 16 * 257, 16 * 577):
        for name, k, n, xd, od in layers:
            x = (torch.randn(rows, k, generator=g, device=dev) * 3).to(xd)
            w = torch.randint(-127, 128, (k, n), generator=g, device=dev).to(torch.int8)
            wt = w.T.contiguous()
            ws = torch.rand(n, generator=g, device=dev) * 1e-3
            b = torch.randn(n, generator=g, device=dev) * 0.1
            q, _ = quant_matmul.quantize_activation(x)
            xb, wb, bb = x.to(bf16), w.to(bf16), b.to(bf16)
            cases.append(Case(
                "K4", f"{name} R={rows} {k}->{n}", f"{names[xd]}->{names[od]}",
                run=lambda x=x, w=w, wt=wt, ws=ws, b=b, od=od: quant_matmul.w8a8_matmul(
                    x, w, ws, b, od, w_t=wt),
                plain=lambda x=x, w=w, ws=ws, b=b, od=od: quant_matmul.w8a8_matmul_plain(x, w, ws, b, od),
                check=exact,
                n_bytes=rows * k * x.element_size() + k * n + 2 * n * 4
                + rows * n * torch.empty((), dtype=od).element_size(),
                n_ops=2 * rows * k * n, kind="int8",
                yardsticks={
                    "int_mm (int8 GEMM only)": lambda q=q, w=w: torch._int_mm(q, w),
                    "addmm bf16 (GEMM + bias only)": lambda xb=xb, wb=wb, bb=bb: torch.addmm(bb, xb, wb),
                },
            ))

    # K5.  ln1 -> qkv and ln2 -> fc1, bf16, at R = 577 (grid), 8 x 577 and
    # 16 x 577 (verify), 16 x 257 (verify at 512) and the ragged 1, 33, 70;
    # the LayerNorm's scale and bias in bf16, as the towers hold them.
    for rows in (577, 8 * 577, 16 * 577, 16 * 257, 1, 33, 70):
        for name, n in (("ln1->qkv", 2304), ("ln2->fc1", 3072)):
            x = (torch.randn(1, rows, 768, generator=g, device=dev) * 3 + 1).to(bf16)
            scale = (1 + 0.1 * torch.randn(768, generator=g, device=dev)).to(bf16)
            lbias = (0.1 * torch.randn(768, generator=g, device=dev)).to(bf16)
            w = (torch.randn(768, n, generator=g, device=dev) * 0.036).to(bf16)
            b = (0.1 * torch.randn(n, generator=g, device=dev)).to(bf16)
            x2, s_b, lb_b = x[0], scale, lbias

            def within_bound(got, want, x=x, scale=scale, lbias=lbias, w=w, b=b):
                bound = ln_matmul.bf16_error_bound(x, scale, lbias, w, b, 1e-5, want)
                diff = (got.float() - want.float()).abs()
                ok = bool((diff <= bound).all()) and bool(got.float().isfinite().all())
                return diff.max().item(), ok, "bf16_error_bound (2 flips of h, 2 ulps)"

            cases.append(Case(
                "K5", f"{name} R={rows} 768->{n}", "bf16",
                run=lambda x=x, scale=scale, lbias=lbias, w=w, b=b: ln_matmul.ln_matmul(x, scale, lbias, w, b, 1e-5),
                plain=lambda x=x, scale=scale, lbias=lbias, w=w, b=b: ln_matmul.ln_matmul_plain(x, scale, lbias, w, b, 1e-5),
                check=within_bound,
                n_bytes=rows * 768 * 2 + 768 * n * 2 + 2 * 768 * 2 + n * 2 + rows * n * 2,
                n_ops=2 * rows * 768 * n, kind="bf16",
                yardsticks={
                    "addmm bf16 (GEMM + bias only)": lambda x2=x2, w=w, b=b: torch.addmm(b, x2, w),
                    "layer_norm + addmm (two calls)": lambda x2=x2, w=w, b=b, s_b=s_b, lb_b=lb_b: torch.addmm(
                        b, F.layer_norm(x2, (768,), s_b, lb_b, 1e-5), w),
                },
            ))

    # K7.  The 192x384 cache (identity height) and a 180x320 one (resized
    # height) into the 768^2 grid of 4x4 cells, B=1 (the grid forward).
    for hw in ((192, 384), (180, 320)):
        cache = torch.randint(0, 256, (640, *hw, 3), generator=g, device=dev, dtype=torch.uint8)
        secs = torch.randperm(640, generator=g, device=dev)[:16]
        frames = cache[secs].permute(0, 3, 1, 2).float()     # prebuilt for the yardstick
        taps = 2 if hw[0] == 192 else 6                       # multiply-adds per value
        for dt in (bf16, f32):
            es = torch.empty((), dtype=dt).element_size()
            cases.append(Case(
                "K7", f"cache {hw[0]}x{hw[1]} -> 768x768x3", names[dt],
                run=lambda cache=cache, secs=secs, dt=dt: pallas_grid.build_detector_grid_pallas(
                    cache, secs, (4, 4), 768, dt),
                plain=lambda cache=cache, secs=secs, dt=dt: pallas_grid.build_detector_grid_pallas_plain(
                    cache, secs, (4, 4), 768, dt),
                check=_close(*tols["K7"][dt]),
                n_bytes=16 * hw[0] * hw[1] * 3 + 768 * 768 * 3 * es,
                n_ops=768 * 768 * 3 * 2 * (taps + 1), kind="f32",
                yardsticks={"interpolate bilinear (resize only)": lambda frames=frames: F.interpolate(
                    frames, size=(192, 192), mode="bilinear", align_corners=False)},
            ))

    # K6.  The grid forward (B=1) at both caches, and B=16 (the batched
    # gate's regime) at 192x384; 64 frames per video.  bf16 out.
    for b, hw in ((1, (192, 384)), (16, (192, 384)), (1, (180, 320))):
        cache = torch.randint(0, 256, (b, 64, *hw, 3), generator=g, device=dev, dtype=torch.uint8)
        secs = torch.randint(0, 64, (b, 16), generator=g, device=dev)
        w = (torch.randn(32, 32, 3, 768, generator=g, device=dev) * 0.02).to(bf16)
        # the width / height matrices in bf16, as the scorer holds them
        awk, gbias = (torch.from_numpy(t).to(dev) for t in grid_embed._width_affine(hw[1], 192))
        awk = awk.to(bf16)
        ah = grid_embed._height_matrix(hw[0], 192)
        ah = None if ah is None else torch.from_numpy(ah).to(dev, bf16)
        canvas = torch.randn(b, 3, 768, 768, generator=g, device=dev).to(bf16)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        kw = dict(grid_shape=(4, 4), cell_hw=(192, 192), patch_size=32)
        cases.append(Case(
            "K6", f"B={b} cache {hw[0]}x{hw[1]} -> 576x768", "u8->bf16",
            run=lambda a=(cache, secs, awk, gbias, ah, w): grid_embed.grid_cell_embed(*a, **kw),
            plain=lambda a=(cache, secs, awk, gbias, ah, w): grid_embed.grid_cell_embed_plain(*a, **kw),
            check=_close(1e-4, bf16_ulp),
            n_bytes=b * 16 * hw[0] * hw[1] * 3 + 3072 * 768 * 2 + b * 576 * 768 * 2,
            n_ops=2 * b * 576 * 3072 * 768, kind="bf16",
            yardsticks={"conv2d stride 32 on a built canvas (GEMM only)":
                        lambda x=canvas, w=w_oihw: F.conv2d(x, w, stride=32)},
        ))

    # K8.  (B, S, 12, 64) views into the fused (B, S, 3*768) projection:
    # B=1 the grid forward, 8 / 16 the verify forwards, S=257 verify at 512.
    for b, s in ((1, 577), (8, 577), (16, 577), (16, 257)):
        base = torch.randn(b, s, 3 * 768, generator=g, device=dev)
        for dt in (bf16, f32):
            qkv = base.to(dt)
            q, k, v = (t.view(b, s, 12, 64) for t in qkv.split(768, dim=-1))
            es = qkv.element_size()
            cases.append(Case(
                "K8", f"B={b} S={s} 12x64", names[dt],
                run=lambda q=q, k=k, v=v: attention.flash_mha(q, k, v),
                plain=lambda q=q, k=k, v=v: attention.flash_mha_plain(q, k, v),
                check=_close(*tols["K8"][dt]),
                n_bytes=4 * b * s * 768 * es, n_ops=4 * b * 12 * s * s * 64, kind=names[dt],
                library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)),
            ))

    # Tensor parallelism (phase 14): K1 at a rank's local heads of B/32, T = 2
    # (6 heads, q|k|v 3 x 384) and T = 4 (3 heads, 3 x 192), and K5 at the
    # local widths of ln1 -> qkv and ln2 -> fc1 that it takes (N a multiple
    # of 128: 1152 and 1536 at T = 2, fc1's 768 at T = 4; qkv's 576 at T = 4
    # is not).  Their own generator keeps the other cases' inputs as they were.
    gtp = torch.Generator(device=dev).manual_seed(14)
    for heads in (6, 3):
        d = heads * 64
        for b in (1, 8):
            qkv = torch.randn(b, 577, 3 * d, generator=gtp, device=dev).to(bf16)
            q, k, v = (qkv[..., i * d:(i + 1) * d].view(b, 577, heads, 64).transpose(1, 2)
                       for i in range(3))
            cases.append(Case(
                "K1", f"B={b} S=577 {heads}x64 (TP {12 // heads})", "bf16",
                run=lambda qkv=qkv, h=heads: attention.fused_mha_from_qkv(qkv, h),
                plain=lambda qkv=qkv, h=heads: attention.fused_mha_from_qkv_plain(qkv, h),
                check=_close(*tols["K1"][bf16]),
                n_bytes=qkv.numel() * 2 + b * 577 * d * 2, n_ops=4 * b * heads * 577 * 577 * 64,
                kind="bf16",
                library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v),
            ))
    for name, n in (("ln1->qkv TP 2", 1152), ("ln2->fc1 TP 2", 1536), ("ln2->fc1 TP 4", 768)):
        x = (torch.randn(1, 577, 768, generator=gtp, device=dev) * 3 + 1).to(bf16)
        scale = (1 + 0.1 * torch.randn(768, generator=gtp, device=dev)).to(bf16)
        lbias = (0.1 * torch.randn(768, generator=gtp, device=dev)).to(bf16)
        w = (torch.randn(768, n, generator=gtp, device=dev) * 0.036).to(bf16)
        b = (0.1 * torch.randn(n, generator=gtp, device=dev)).to(bf16)

        def within_bound(got, want, x=x, scale=scale, lbias=lbias, w=w, b=b):
            bound = ln_matmul.bf16_error_bound(x, scale, lbias, w, b, 1e-5, want)
            diff = (got.float() - want.float()).abs()
            ok = bool((diff <= bound).all()) and bool(got.float().isfinite().all())
            return diff.max().item(), ok, "bf16_error_bound (2 flips of h, 2 ulps)"

        cases.append(Case(
            "K5", f"{name} R=577 768->{n}", "bf16",
            run=lambda x=x, scale=scale, lbias=lbias, w=w, b=b: ln_matmul.ln_matmul(x, scale, lbias, w, b, 1e-5),
            plain=lambda x=x, scale=scale, lbias=lbias, w=w, b=b: ln_matmul.ln_matmul_plain(x, scale, lbias, w, b, 1e-5),
            check=within_bound,
            n_bytes=577 * 768 * 2 + 768 * n * 2 + 2 * 768 * 2 + n * 2 + 577 * n * 2,
            n_ops=2 * 577 * 768 * n, kind="bf16",
            yardsticks={"layer_norm + addmm (two calls)": lambda x=x[0], w=w, b=b, s_b=scale, lb_b=lbias: torch.addmm(
                b, F.layer_norm(x, (768,), s_b, lb_b, 1e-5), w)},
        ))

    # K4's row-parallel mode (phase 15): a rank's share of fc2 at T = 2
    # (1536 -> 768) and T = 4 (768 -> 768), at R = 577 (grid) and 8 x 577
    # (a bucket of 8), f32 in (fc1 writes f32).  The rows' scales are the
    # whole rows' (here a wider x's, as the MAX all-reduce gives them); out
    # the int32 partial product.  Exactly equal.  Its own generator keeps
    # the other cases' inputs as they were.
    grow = torch.Generator(device=dev).manual_seed(15)
    for rows in (577, 8 * 577):
        for name, k in (("fc2 TP 2", 1536), ("fc2 TP 4", 768)):
            whole = torch.randn(rows, 3072, generator=grow, device=dev) * 3
            x = whole[:, :k].contiguous()
            xs = quant_matmul.activation_scale(quant_matmul.row_absmax(whole))
            w = torch.randint(-127, 128, (k, 768), generator=grow, device=dev).to(torch.int8)
            wt = w.T.contiguous()
            q = quant_matmul.quantize_rows(x, xs)
            cases.append(Case(
                "K4", f"row-parallel {name} R={rows} {k}->768", "f32->int32",
                run=lambda x=x, xs=xs, w=w, wt=wt: quant_matmul.w8a8_matmul_rowpar(x, xs, w, w_t=wt),
                plain=lambda x=x, xs=xs, w=w: quant_matmul.w8a8_matmul_rowpar_plain(x, xs, w),
                check=exact,
                n_bytes=rows * k * 4 + k * 768 + rows * 4 + rows * 768 * 4,
                n_ops=2 * rows * k * 768, kind="int8",
                yardsticks={"int_mm (int8 GEMM only)": lambda q=q, w=w: torch._int_mm(q, w)},
            ))

    cases += decode_cases(torch)
    cases += moe_cases(torch)
    cases += mla_cases(torch)
    return cases


def bf16_ulp_check(row=None, exact=None, ulps=1):
    """D1-D3's check: |got - want| <= one bf16 ulp of each value of the
    plain result or, with ``row``, of the largest of each run of ``row``
    values (an attention head's output).  The kernels round where their
    plain versions round and sum in another order, so a sum whose last f32
    bit differs may round the other way: a norm's or an activation's value
    by one ulp of itself, an attention logit or probability by one ulp,
    which moves every value of its head by about a ulp of its largest.  A
    tuple's first entry (the residual) must be equal, as must each pair of
    tensors ``exact()`` gives (the cache the kernel wrote, the plain one's).
    ``ulps`` widens the bound to that many ulps."""
    import torch

    def check(got, want, x=None):
        tol = (f"{ulps} bf16 ulp{'s' if ulps > 1 else ''} "
               + ("of its head's largest" if row else "of each value"))
        same = True
        if isinstance(got, tuple):
            same, tol = torch.equal(got[0], want[0]), tol + ", the residual exact"
            got, want = got[1], want[1]
        if exact is not None:
            same = same and all(torch.equal(a, b) for a, b in exact())
            tol += ", the cache exact"
        scale = want.float().abs()
        if row is not None:
            scale = scale.reshape(-1, row).amax(dim=-1, keepdim=True).expand(-1, row)
            scale = scale.reshape(want.shape)
        ulp = ulps * torch.exp2(torch.floor(torch.log2(scale.clamp_min(2.0 ** -126))) - 7)
        diff = (got.float() - want.float()).abs()
        ok = same and bool((diff <= ulp).all()) and bool(got.float().isfinite().all())
        return diff.max().item(), ok, tol
    return check


def decode_cases(torch):
    """D1-D3 (``kernels/decode.py``), the decode step's kernels at Qwen2-7B's
    widths: B = 1 (grounding) and 4 (batched QA), D = 3,584, I = 18,944, 28 /
    4 heads at slot 2,400 of grounding's 2,432-slot bucket (a run of prompt
    padding masked), and a tensor-parallel rank's 14 / 2 and 7 / 1.  Timed
    in CUDA graphs, as the decode step replays them.  Yardsticks: the
    library call that computes part of the function (``F.rms_norm`` without
    the residual add; SDPA's grouped-query mode over the live slots, without
    bias, mRoPE or cache write); SiLU * up has none.  Its own generator
    keeps the other cases' inputs as they were."""
    from torch.nn import functional as F

    from tstar_tpu_torch.kernels import decode
    from tstar_tpu_torch.models.qwen2vl import mrope_cos_sin

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(19)

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(bf16)

    cases = []
    d, inter = 3584, 18944
    for rows in (1, 4):
        x, delta = randn(rows, 1, d, std=3.0), randn(rows, 1, d)
        scale = randn(d, std=0.2) + 1.0
        cases.append(Case(
            "D1", f"B={rows} D={d}", "bf16",
            run=lambda x=x, delta=delta, scale=scale: decode.add_rms_norm(x, delta, scale, 1e-6),
            plain=lambda x=x, delta=delta, scale=scale: decode.add_rms_norm_plain(
                x, delta, scale, 1e-6),
            check=bf16_ulp_check(),
            # x, delta, the residual and the output a row; the scale once
            n_bytes=2 * (4 * rows * d + d), n_ops=5 * rows * d, kind="f32",
            yardsticks={"rms_norm (no residual add)": lambda x=x, scale=scale: F.rms_norm(
                x, (d,), scale, 1e-6)},
            graphed=True,
        ))
    for rows in (1, 4):
        gate, up = randn(rows, 1, inter, std=3.0), randn(rows, 1, inter)
        cases.append(Case(
            "D3", f"B={rows} I={inter}", "bf16",
            run=lambda gate=gate, up=up: decode.silu_mul(gate, up),
            plain=lambda gate=gate, up=up: decode.silu_mul_plain(gate, up),
            check=bf16_ulp_check(),
            n_bytes=2 * 3 * rows * inter, n_ops=5 * rows * inter, kind="f32", graphed=True,
        ))
    slots, index = 2432, 2400
    for batch, nh, nkv in ((1, 28, 4), (4, 28, 4), (1, 14, 2), (1, 7, 1)):
        q, k, v = (randn(batch, 1, n * 128) for n in (nh, nkv, nkv))
        biases = [randn(n * 128, std=0.5) for n in (nh, nkv, nkv)]
        cache = tuple(randn(batch, slots, nkv, 128) for _ in range(2))
        plain_cache = tuple(t.clone() for t in cache)
        valid = torch.ones(batch, slots, dtype=torch.bool, device=dev)
        valid[:, 600:610] = False                  # prompt padding
        valid[:, index + 1:] = False
        bias = torch.where(valid[:, None, None, :], 0.0, torch.finfo(torch.float32).min)
        pos = torch.full((3, batch, 1), index, dtype=torch.int64, device=dev)
        cos, sin = mrope_cos_sin(pos, 128, (16, 24, 24), 1e6)
        at = torch.tensor(index, device=dev)
        args = (q, k, v, *biases, cos, sin, bias)
        qh = q.reshape(batch, nh, 1, 128)
        kh, vh = (t[:, :index + 1].transpose(1, 2) for t in cache)
        live = index + 1
        # q, k, v and their biases in, the old slots' K / V read, this
        # token's written, the output; cos, sin and the live mask in f32
        n_bytes = (2 * (batch * (nh + 2 * nkv) * 128 + (nh + 2 * nkv) * 128
                        + 2 * batch * index * nkv * 128 + 2 * batch * nkv * 128
                        + batch * nh * 128)
                   + 4 * (2 * batch * 128 + batch * live))
        cases.append(Case(
            "D2", f"B={batch} {live} of {slots} slots {nh}/{nkv} heads", "bf16",
            run=lambda args=args, cache=cache, at=at, nh=nh, nkv=nkv: decode.decode_attention(
                *args, cache, at, nh, nkv),
            plain=lambda args=args, pc=plain_cache, at=at, nh=nh, nkv=nkv:
                decode.decode_attention_plain(*args, pc, at, nh, nkv),
            check=bf16_ulp_check(row=128, exact=lambda cache=cache, pc=plain_cache: zip(cache, pc)),
            n_bytes=n_bytes, n_ops=4 * batch * nh * live * 128, kind="bf16",
            yardsticks={"sdpa gqa (no bias, mRoPE or cache write)":
                        lambda qh=qh, kh=kh, vh=vh: F.scaled_dot_product_attention(
                            qh, kh, vh, enable_gqa=True)},
            graphed=True,
        ))
    return cases


def moe_cases(torch):
    """M1-M2 (``kernels/moe.py``), Kimi-VL's router and experts of the decode
    step at the published widths: D = 2,048, 64 experts of 1,408, 6 a token
    (two tokens of the four share their choice, so each expert is read
    once), 2 shared, for 1 and 4 tokens.  Timed in CUDA graphs, as the
    decode step replays them.  M1's ids must equal the plain router's and
    its weights agree to f32 rounding; M2 within 2 bf16 ulps of its output's
    largest (a gate, an up or an expert's bf16 rounding may flip).  M2's
    plain version is the prefill's route (``moe_grouped``,
    ``torch._grouped_mm``); its yardstick gathers the chosen experts'
    weights (a copy of every chosen expert a step) into batched products."""
    from tstar_tpu_torch.kernels import moe
    from tstar_tpu_torch.kernels.decode import silu_mul_plain

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(20)
    d, e, i, k, ns = 2048, 64, 1408, 6, 2

    def weight(*shape):
        return (torch.randn(*shape, generator=g, device=dev) / shape[-1] ** 0.5).to(bf16)

    w13, w2, sw13, sw2 = weight(e, 2 * i, d), weight(e, d, i), weight(2 * ns * i, d), weight(d, ns * i)
    gate, bias = weight(e, d), (torch.randn(e, generator=g, device=dev) * 0.02).to(bf16)

    def route_check(got, want, x=None):
        err = (got[1] - want[1]).abs().max().item()
        ok = torch.equal(got[0], want[0]) and err <= 1e-5 * want[1].abs().max().item()
        return err, ok, "ids exact, weights 1e-5 of the largest"

    def gathered(x, ids, weights):
        gu = torch.matmul(w13[ids], x[:, None, :, None])[..., 0]         # (T, K, 2I)
        y = torch.matmul(w2[ids], silu_mul_plain(gu[..., :i], gu[..., i:])[..., None])[..., 0]
        return (y.float() * weights[..., None]).sum(dim=1).to(x.dtype) + moe.shared_experts(
            x, sw13, sw2)

    def ulps_of_largest(got, want, x=None):
        err = (got.float() - want.float()).abs().max().item()
        return err, err <= 2 ** -7 * want.float().abs().max().item(), "2 bf16 ulps of the largest"

    cases = []
    for rows in (1, 4):
        x = torch.randn(rows, d, generator=g, device=dev).to(bf16)
        ids, weights = moe.route(x, gate, bias, k, 2.446)
        if rows > 1:
            ids[1] = ids[0]
        n_experts = len(set(ids.flatten().tolist())) + ns
        cases.append(Case(
            "M1", f"B={rows} D={d} E={e} K={k}", "bf16",
            run=lambda x=x: moe.moe_route(x, gate, bias, k, 2.446),
            plain=lambda x=x: moe.route(x, gate, bias, k, 2.446),
            check=route_check,
            # the gate, the bias and the tokens read, ids and weights written
            n_bytes=2 * (e * d + e + rows * d) + 12 * rows * k, n_ops=2 * rows * e * d, kind="f32",
            graphed=True,
        ))
        cases.append(Case(
            "M2", f"B={rows} {n_experts - ns} experts + {ns} shared D={d} I={i}", "bf16",
            run=lambda x=x, ids=ids, weights=weights: moe.moe_decode(
                x, ids, weights, w13, w2, sw13, sw2),
            plain=lambda x=x, ids=ids, weights=weights: moe.moe_grouped(
                x, ids, weights, w13, w2, sw13, sw2),
            check=ulps_of_largest,
            # each chosen and shared expert's rows once, the tokens in and out
            n_bytes=2 * 3 * d * i * n_experts + rows * (4 * d + 12 * k),
            n_ops=2 * 3 * d * i * rows * (k + ns), kind="bf16",
            yardsticks={"gathered experts": lambda x=x, ids=ids, weights=weights: gathered(
                x, ids, weights)},
            graphed=True,
        ))
    return cases


def mla_cases(torch):
    """The latent-attention decode kernels (``kernels/mla.py``, three
    launches a call) at Kimi-VL's widths (16 heads, kv_lora_rank 512, rope
    64, nope and v 128): B = 1 (grounding) and 4, at 1, 2,401 and 3,500 live
    slots of a 3,584-slot bucket (a run of prompt padding masked), timed in
    CUDA graphs as the decode step replays them.  Each call of a timed graph reads its own copy
    of W_UK, W_UV and the cache, six copies in turn (more than the 50 MB L2
    holds at 3,500 slots), so the bytes come from memory as a step's 27
    layers bring them.  Held to ``mla_decode_plain``: the cache exact, each
    head's output within 2 bf16 ulps of its largest (the kernel rounds its
    probabilities before normalising them).  No library yardstick: no one
    PyTorch call computes it."""
    from tstar_tpu_torch.kernels import mla
    from tstar_tpu_torch.models.kimi_vl import rope_cos_sin

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(21)
    slots, copies, width = 3584, 6, 16 * 192 + 576

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(bf16)

    def turns(fn, sets):
        """``fn`` on each set of operands in turn, one a call."""
        at = [0]

        def call():
            out = fn(*sets[at[0] % len(sets)])
            at[0] += 1
            return out
        return call

    w_sets = [(randn(16, 128, 512, std=128 ** -0.5), randn(16, 512, 128, std=512 ** -0.5))
              for _ in range(copies)]
    norm = randn(512, std=0.1) + 1.0
    cases = []
    for batch in (1, 4):
        caches = [randn(batch, slots, 576) for _ in range(copies)]
        plain_caches = [c.clone() for c in caches]
        for live in (1, 2401, 3500):
            index = live - 1
            y = randn(batch, 1, width)
            cos, sin = rope_cos_sin(torch.full((batch, 1), index, device=dev), 64, 800000.0)
            valid = torch.arange(slots, device=dev) <= index
            valid[600:610] = False
            bias = torch.where(valid, 0.0, torch.finfo(torch.float32).min).expand(
                batch, 1, 1, slots).contiguous()
            at = torch.tensor(index, device=dev)

            def step(cache, w_uk, w_uv, y=y, cos=cos, sin=sin, bias=bias, at=at, fn=None):
                return fn(y, cos, sin, norm, 1e-6, cache, at, w_uk, w_uv, bias)

            kernel = [(c, *w) for c, w in zip(caches, w_sets)]
            plain = [(c, *w) for c, w in zip(plain_caches, w_sets)]
            # the projection, the rope tables, the scale and the live mask in; W_UK
            # and W_UV; the live slots read but this step's, which is written; the
            # output rows
            n_bytes = (2 * (batch * width + 2 * 16 * 128 * 512 + 512 + batch * index * 576
                            + batch * 576 + batch * 16 * 128)
                       + 4 * (2 * batch * 64 + batch * live))
            n_ops = 2 * batch * 16 * (128 * 512 + live * 576 + live * 512 + 512 * 128)
            cases.append(Case(
                "MLA", f"B={batch} {live} of {slots} slots", "bf16",
                run=turns(functools.partial(step, fn=mla.mla_decode), kernel),
                plain=turns(functools.partial(step, fn=mla.mla_decode_plain), plain),
                check=bf16_ulp_check(row=128, ulps=2, exact=lambda c=caches, pc=plain_caches:
                                     zip(c, pc)),
                n_bytes=n_bytes, n_ops=n_ops, kind="bf16", graphed=True,
            ))
    return cases


def ptxas_props():
    """ptxas -v of the built library: {kernel: {"registers", "spills"}}."""
    import re

    from tstar_tpu_torch.kernels import _build

    props, current = {}, None
    for line in _build.ptxas_report(_build.library_path()).read_text().splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            props.setdefault(current, {})["spills"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            props.setdefault(current, {})["registers"] = int(m.group(1))
    return props


def phase_build(torch):
    """Phase 2: build the kernels; the bf16 attention kernels must run on
    wgmma and TMA (their SASS holds HGMMA and UTMALDG), K4 on integer wgmma
    and TMA (IGMMA, UTMALDG), and neither spills; K3's registers and spills
    are printed, and the grids K4 and the attention kernel take."""
    import ctypes
    import re
    import shutil
    from pathlib import Path

    from tstar_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    lib = _build.load()
    path = _build.library_path()
    log(f"[build] CUDA kernels built and loaded in {time.perf_counter() - t0:.2f} s ({path.name})")
    cuobjdump = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    bodies = {}
    for chunk in sass.split("Function : ")[1:]:
        name, _, body = chunk.partition("\n")
        bodies[name.strip()] = body
    props = ptxas_props()
    def sass_check(name, label, ops):
        """SASS counts of ``ops`` (each must occur) and ptxas's spills (0)."""
        body, prop = bodies[name], props.get(name, {})
        counts = {op: len(re.findall(rf"\b{op}\b", body)) for op in ops}
        ok = all(counts[op] > 0 for op in ops[:2]) and prop.get("spills") == 0
        log(f"[build] {label}: SASS {counts}; ptxas {prop.get('registers')} registers, "
            f"{prop.get('spills')} bytes spilled {'OK' if ok else 'FAIL'}")
        return ok

    failed = []
    attn = sorted(n for n in bodies if "attn_sm90_kernel" in n)
    for name in attn:
        m = re.search(r"attn_sm90_kernelILi(\d)ELi(\d)E", name)
        label = f"mode {m.group(1)} ({['K1', 'K1 P16', 'K8'][int(m.group(1))]}), {m.group(2)} warpgroup(s)" if m else name
        if not sass_check(name, f"attn_sm90_kernel {label}", ("HGMMA", "UTMALDG", "UTMASTG")):
            failed.append(label)
    if len(attn) != 6 or failed:
        raise SystemExit(f"bf16 attention kernels: {len(attn)} found (want 6), failing {failed}")
    # K4: one instance per (x, out) dtype pair and tile (128-row slab with
    # wgmma n = 128, or 64-row with n = 64), each on integer wgmma fed by TMA;
    # out int32 is the row-parallel mode (phase 15).
    w8a8 = sorted(n for n in bodies if "w8a8_kernel" in n)
    out_names = {"f": "f32", "i": "int32 (row-parallel mode)"}
    for name in w8a8:
        m = re.search(r"w8a8_kernelI(\w+?)(S1_|f|i|13__nv_bfloat16)Li(\d)E", name)
        label = f"K4 w8a8_kernel {name}" if not m else (
            f"K4 w8a8_kernel x {'f32' if m.group(1) == 'f' else 'bf16'} -> "
            f"{out_names.get(m.group(2), 'bf16')}, {64 * int(m.group(3))}-row slab")
        if not sass_check(name, label, ("IGMMA", "UTMALDG")):
            failed.append(label)
    if len(w8a8) != 12 or failed:
        raise SystemExit(f"K4 kernels: {len(w8a8)} found (want 12), failing {failed}")
    # K2 (bf16): one instance per output columns per CTA (64, 128, 256) and
    # values per TMA segment of a (pw, c) run (32, 16); K5: one per row path
    # (D = 768 in registers, other widths read twice) and columns per
    # warpgroup (64, 128); each on bf16 wgmma fed by TMA.
    for kernel, label, want in (("patch_embed_sm90_kernel", "K2", 6), ("ln_matmul_kernel", "K5", 4),
                                ("grid_embed_sm90_kernel", "K6", 4)):
        found = sorted(n for n in bodies if kernel in n)
        for name in found:
            m = re.search(rf"{kernel}I(L[ib]\d+E)+", name)
            args = ", ".join(re.findall(r"L[ib](\d+)E", m.group(0))) if m else ""
            tag = f"{label} {kernel}<{args}>" if m else f"{label} {name}"
            if not sass_check(name, tag, ("HGMMA", "UTMALDG")):
                failed.append(tag)
        if len(found) != want or failed:
            raise SystemExit(f"{label} kernels: {len(found)} found (want {want}), failing {failed}")
    # K3: one instance per dtype and 16-byte vectors a lane (the towers' are
    # 3 (D = 768) and 2 (D = 512) in bf16, 6 and 4 in f32), and one per dtype
    # of the version that reads a row twice (layernorm_wide_kernel).
    ln = sorted(n for n in props if "layernorm_" in n)
    regs = [props[n].get("registers") for n in ln]
    spills = sum(props[n].get("spills", 0) for n in ln)
    log(f"[build] K3 layernorm_kernel: {len(ln)} instances, {min(regs)}-{max(regs)} registers, "
        f"{spills} bytes spilled in all")
    for name in ln:
        log(f"[build]   {name}: {props[name].get('registers')} registers, "
            f"{props[name].get('spills')} bytes spilled")
    # the latent-attention decode kernels: the attention on mma.sync (HMMA)
    # fed by TMA (UTMALDG) and ldmatrix (LDSM); none spills
    for kernel, ops in (("mla_q_kernel", ("FFMA", "STG")),
                        ("mla_attend_kernel", ("HMMA", "UTMALDG", "LDSM")),
                        ("mla_out_kernel", ("FFMA", "STG"))):
        found = [n for n in bodies if kernel in n]
        if len(found) != 1 or not sass_check(found[0], f"MLA {kernel}", ops):
            raise SystemExit(f"{kernel}: {len(found)} found (want 1), or without {ops}, or spills")
    # K7: one instance per output dtype (f32, bf16)
    for name in sorted(n for n in props if "grid_pack_kernel" in n):
        log(f"[build] K7 {name}: {props[name].get('registers')} registers, "
            f"{props[name].get('spills')} bytes spilled")
    cfg = (ctypes.c_int * 6)()
    for r in (577, 16 * 257, 16 * 577):
        for k, n in ((768, 2304), (768, 768), (768, 3072), (3072, 768)):
            _build.check(lib.tstar_w8a8_config(r, k, n, cfg), "tstar_w8a8_config")
            log(f"[build] K4 grid at R={r} K={k} N={n}: {cfg[0]} CTAs of {cfg[3]} rows x {cfg[1]} N "
                f"tile(s) of 128 in clusters of {cfg[5]} (sharing a slab's quantization), "
                f"{cfg[2]} W^T stages, {cfg[4]} B dynamic shared memory")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, hw, p in ((1, 768, 32), (3, 768, 32), (8, 768, 32), (16, 768, 32), (8, 512, 32),
                     (16, 512, 32), (1, 768, 16)):
        _build.check(lib.tstar_patch_embed_config(b, hw, hw, 3, p, 768, cfg),
                     "tstar_patch_embed_config")
        log(f"[build] K2 grid at B={b} {hw}x{hw} patch {p}: {cfg[0]} CTAs of 16x8 patches x "
            f"{cfg[1]} columns ({-(-cfg[0] // sms)} wave(s) on {sms} SMs, one CTA an SM), "
            f"{cfg[2]} stages of {cfg[4]} K chunk(s) of {cfg[5]}, {cfg[3]} B dynamic shared memory")
    # K6: the grid forward (B=1) at both caches, B=3 and 16, patch 16
    for b, (ch, cw), p in ((1, (192, 384), 32), (1, (180, 320), 32), (3, (192, 384), 32),
                           (16, (192, 384), 32), (1, (192, 384), 16)):
        _build.check(lib.tstar_grid_embed_config(b, 640, ch, cw, 4, 4, 192, 192, p, 768,
                                                 int(ch != 192), cfg), "tstar_grid_embed_config")
        log(f"[build] K6 grid at B={b} cache {ch}x{cw} patch {p}: {cfg[0]} CTAs of 128 patches x "
            f"{cfg[1]} columns in clusters of {cfg[2]} (splitting K along the patch rows), "
            f"{cfg[3]} stages of {64 // max(cfg[5], 1)} K chunk(s) of {cfg[5]} values, "
            f"{cfg[4]} B dynamic shared memory")
    for r in (1, 577, 8 * 577, 16 * 257, 16 * 577):
        for n in (2304, 3072):
            _build.check(lib.tstar_ln_matmul_config(r, 768, n, cfg), "tstar_ln_matmul_config")
            log(f"[build] K5 grid at R={r} D=768 N={n}: {cfg[0]} CTAs of 64 rows x {cfg[1]} N "
                f"tile(s) of {2 * cfg[5]} in clusters of {cfg[3]} (sharing a slab's "
                f"normalization), {cfg[2]} W stages, {cfg[4]} B dynamic shared memory")
    for b, s in ((1, 577), (8, 577), (16, 577), (16, 257)):
        _build.check(lib.tstar_attn_config(b, s, 12, cfg), "tstar_attn_config")
        log(f"[build] attention grid at B={b} S={s} 12 heads: {cfg[0]} consumer warpgroup(s) "
            f"({64 * cfg[0]} query rows) per CTA, {cfg[1]} K/V stages "
            f"({'all resident' if cfg[2] else 'streamed'}), {cfg[3]} B dynamic shared memory")


def phase_kernels(torch, card):
    """Phase 3: every kernel against its plain version; returns summary rows."""
    rows_out = []
    for c in kernel_cases(torch):
        got = c.run()
        torch.cuda.synchronize()
        want = c.plain()
        err, ok, tol = c.check(got, want)
        timer = graph_ms if c.graphed else cuda_ms
        ms, plain_ms = timer(c.run), timer(c.plain)
        lib_ms = timer(c.library) if c.library is not None else None
        yard = {k: timer(fn) for k, fn in c.yardsticks.items()}
        b_ms, b_by = bound_ms(c.n_bytes, c.n_ops, c.kind)
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        extra = "".join(f" {k}={v:.4f} ms" for k, v in yard.items())
        log(f"[kernels] {c.kernel} {c.shape} {c.dtype}: max_abs_err={err:.3e} tol={tol} "
            f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms library={lib}{extra} "
            f"bound={b_ms:.4g} ms ({b_by}: {c.n_bytes / 1e6:.4f} MB, {c.n_ops / 1e9:.3f} GOP) "
            f"{'(in a CUDA graph) ' if c.graphed else ''}({card}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{c.kernel} {c.shape} {c.dtype} disagrees with its plain version")
        rows_out.append({
            "kernel": c.kernel, "shape": c.shape, "dtype": c.dtype, "err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "yardsticks": yard,
        })
    return rows_out


def phase_tower(torch):
    """Phase 4: full-width B/32 on the card (bf16, kernels) vs CPU (f32, plain).
    Returns what phase 4b reuses: the two models, the grid's inputs, prompts."""
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

    def pixels(device, dtype):
        cache = torch.from_numpy(host.frames).to(device)
        return build_detector_grid(cache, secs.to(device), (4, 4), 768, dtype)

    def queries(model, device):
        q = model.encode_text(torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device))
        return q, torch.from_numpy(ids[:, 0] > 0).to(device)

    def run(model, device, dtype):
        with torch.no_grad():
            q, qmask = queries(model, device)
            logits, boxes = model.predict(model.encode_image(pixels(device, dtype)), q, qmask)
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
    return {"cfg": cfg, "cpu_model": cpu_model, "gpu_model": gpu_model, "pixels": pixels,
            "queries": queries, "cpu_scores": cs, "host": host, "secs": secs}


def phase_int8_tower(torch, tower):
    """Phase 4b: the full-width int8 tower, bf16 with K4 on the card, against
    the bf16 tower on the card and the same int8 weights in f32 on the CPU."""
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.models.owlvit import postprocess_detections
    from tstar_tpu_torch.models.owlvit_quant import (
        encode_image_int8, quantize_vision_tower, route_counts,
    )

    cfg, cpu_model, gpu_model = tower["cfg"], tower["cpu_model"], tower["gpu_model"]
    qp_cpu = quantize_vision_tower(cpu_model)   # from the f32 weights, for both sides
    routes = route_counts(qp_cpu)

    def to_cuda(tree):
        if isinstance(tree, dict):
            return {k: to_cuda(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(to_cuda(v) for v in tree)
        return tree.to("cuda") if isinstance(tree, torch.Tensor) else tree

    qp_gpu = to_cuda(qp_cpu)
    with torch.no_grad():
        px = tower["pixels"]("cuda", torch.bfloat16)
        reset_launch_counts()
        feats_q = encode_image_int8(qp_gpu, px, cfg, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        counts = launch_counts()
        feats_b = gpu_model.encode_image(px)
        q, qmask = tower["queries"](gpu_model, "cuda")
        gs = postprocess_detections(*gpu_model.predict(feats_q, q, qmask), (768, 768))[0]
        cq, cmask = tower["queries"](cpu_model, "cpu")
        feats_c = encode_image_int8(qp_cpu, tower["pixels"]("cpu", torch.float32), cfg,
                                    dtype=torch.float32)
        cs = postprocess_detections(*cpu_model.predict(feats_c, cq, cmask), (768, 768))[0]
    a, b = feats_q.float(), feats_b.float()
    cos = ((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1) + 1e-9)).min().item()
    score_err = (gs.float().cpu() - cs).abs().max().item()
    vs_bf16 = (gs.float().cpu() - tower["cpu_scores"]).abs().max().item()
    # Cosine bound from the reference's int8 tower test (tests/test_quant.py:
    # min per-patch cosine > 0.98 against the float tower).  Scores: bf16
    # activations move many int8 roundings away from the f32 run's (one
    # quantization step each), on top of phase 4's bf16 rounding (2e-2).
    cos_min, tol = 0.98, 5e-2
    ok = (cos > cos_min and score_err <= tol and bool(torch.isfinite(gs).all())
          and counts["w8a8_matmul"] == 4 * cfg.vision.num_layers
          and routes == {"k4": 4 * cfg.vision.num_layers})
    log(f"[int8 tower] B/32 full width, one 768^2 grid image: route plan {routes} (want every "
        f"dense layer on K4); K4 launches {counts['w8a8_matmul']} "
        f"(want {4 * cfg.vision.num_layers}); min per-patch feature cosine int8 vs bf16 tower "
        f"{cos:.4f} (bound > {cos_min}); max |score int8 cuda-bf16 - int8 cpu-f32| = "
        f"{score_err:.3e} (tol {tol:.0e}); max |score int8 - float f32| = {vs_bf16:.3e} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("int8 tower on the card disagrees with its references")


def phase_route_tower(torch, tower):
    """Phase 4c: the phase-4 grid on the card through K6 + ``encode_patches``,
    and the phase-4 image under ``TSTAR_FUSED_MHA=0 TSTAR_FLASH_ATTENTION=1``
    (K8), each against the CPU f32 pixel chain's scores."""
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.kernels.grid_embed import _width_affine, grid_cell_embed
    from tstar_tpu_torch.models.owlvit import postprocess_detections
    from tstar_tpu_torch.tools.profile_search import environ

    model = tower["gpu_model"]
    with torch.no_grad():
        q, qmask = tower["queries"](model, "cuda")

        def scores(feats):
            return postprocess_detections(*model.predict(feats, q, qmask), (768, 768))[0]

        cache = torch.from_numpy(tower["host"].frames).to("cuda")
        awk, bias = (torch.from_numpy(t).to("cuda") for t in _width_affine(384, 192))
        reset_launch_counts()
        emb = grid_cell_embed(
            cache[None], tower["secs"].to("cuda")[None], awk, bias, None,
            model.vision.patch_embedding.kernel, grid_shape=(4, 4), cell_hw=(192, 192),
            patch_size=32,
        )
        runs = {"K6 + encode_patches": (scores(model.encode_patches(emb)), launch_counts())}
        with environ({"TSTAR_FUSED_MHA": "0", "TSTAR_FLASH_ATTENTION": "1"}):
            reset_launch_counts()
            feats = model.encode_image(tower["pixels"]("cuda", torch.bfloat16))
            runs["K8 flash route"] = (scores(feats), launch_counts())
        torch.cuda.synchronize()
    want = {"K6 + encode_patches": {"grid_cell_embed": 1, "patch_embed_matmul": 0},
            "K8 flash route": {"flash_mha": 12, "fused_mha_from_qkv": 0}}
    tol = 2e-2   # phase 4's: twelve layers of bf16 rounding on random weights
    for label, (gs, counts) in runs.items():
        err = (gs.float().cpu() - tower["cpu_scores"]).abs().max().item()
        ok = (err <= tol and bool(torch.isfinite(gs).all()) and gs.shape == (1, 576)
              and all(counts[k] == n for k, n in want[label].items()))
        log(f"[route tower] {label}: B/32 full width, one 768^2 grid, max |score cuda-bf16 - "
            f"cpu-f32 pixel chain| = {err:.3e} (tol {tol:.0e}); launches "
            f"{ {k: counts[k] for k in want[label]} } {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{label}: the full-width tower on the card disagrees")


def phase_widths(torch, tower):
    """Phase 4d: an encoder layer at SigLIP's widths (D = 1152 for K3, heads
    of 72 that K1 does not take) on the card against the same layer on the
    CPU, in bf16 and f32, launching K3 twice and no other kernel; then the
    phase-4 B/32 towers' LayerNorms and unbiased attentions, each of which
    must launch K3 / K1."""
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.models import transformer
    from tstar_tpu_torch.tools.profile_search import environ

    torch.manual_seed(0)
    layer = transformer.EncoderLayer(1152, 16, 4304, eps=1e-6).requires_grad_(False)
    for name, p in layer.named_parameters():
        if "kernel" in name:
            torch.nn.init.normal_(p, std=p.shape[0] ** -0.5)
        else:
            torch.nn.init.normal_(p, mean=1.0 if "scale" in name else 0.0, std=0.1)
    x = 2 * torch.randn(2, 37, 1152)
    # f32: summation order only; bf16: two ulps of the residual stream's
    # magnitude plus 2e-2 relative (tests/test_torch_widths.py)
    tols = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (6.25e-2, 2e-2)}
    plain = {"TSTAR_FUSED_MHA": "1", "TSTAR_LN_MATMUL": "0", "TSTAR_FLASH_ATTENTION": ""}
    with torch.no_grad(), environ(plain):
        for dt, (atol, rtol) in tols.items():
            lyr = layer.to(dt)
            want = lyr(x.to(dt)).float()
            reset_launch_counts()
            got = lyr.to("cuda")(x.to("cuda", dt)).float().cpu()
            torch.cuda.synchronize()
            counts = launch_counts()
            layer = lyr.to("cpu")
            diff = (got - want).abs()
            others = sum(v for k, v in counts.items() if k != "fused_layernorm")
            ok = (bool((diff <= atol + rtol * want.abs()).all()) and bool(got.isfinite().all())
                  and counts["fused_layernorm"] == 2 and others == 0)
            log(f"[widths] EncoderLayer D=1152, 16 heads x 72, S=37, {str(dt)[6:]}: max |cuda - "
                f"cpu| = {diff.max().item():.3e} (atol {atol:.0e} + rtol {rtol:.0e}*|ref|), "
                f"K3 launches {counts['fused_layernorm']} (want 2), other kernels {others} "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("SigLIP-width layer on the card disagrees with the CPU")

        model, cfg = tower["gpu_model"], tower["cfg"]
        norms, apply_ln = [], transformer.apply_layernorm

        def counted(x, *args):
            norms.append(x.shape[-1])
            return apply_ln(x, *args)

        transformer.apply_layernorm = counted
        try:
            ids = torch.randint(1, cfg.text.vocab_size, (2, cfg.text.max_length), device="cuda")
            runs = {"vision (one 768^2 grid)": (
                        lambda: model.encode_image(tower["pixels"]("cuda", torch.bfloat16)),
                        cfg.vision.num_layers),
                    "text (causal, biased)": (
                        lambda: model.encode_text(ids, torch.ones_like(ids)), 0)}
            for label, (run, attn) in runs.items():
                norms.clear()
                reset_launch_counts()
                run()
                torch.cuda.synchronize()
                counts = launch_counts()
                ok = (counts["fused_layernorm"] == len(norms) > 0
                      and counts["fused_mha_from_qkv"] == attn)
                log(f"[widths] B/32 {label} tower: {len(norms)} LayerNorms, K3 launches "
                    f"{counts['fused_layernorm']}; K1 launches {counts['fused_mha_from_qkv']} "
                    f"(want {attn}) {'OK' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"B/32 {label}: a LayerNorm or attention missed its kernel")
        finally:
            transformer.apply_layernorm = apply_ln


def run_search(torch, card, heur, label, config, per_forward, env=None):
    """One warm-up and one measured ``KeyframeSearcher.search()`` with
    ``config`` (and ``env`` set for both, restored after); the measured one
    runs with every launch count set to 0 just before it.  ``per_forward``
    (see ``launches``): each kernel's launches per detector forward, or per
    grid and per verification forward; the counts must equal it times the
    forwards.  Returns the launch counts."""
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.search.searcher import KeyframeSearcher
    from tstar_tpu_torch.tools.profile_search import environ
    from tstar_tpu_torch.video.synthetic import default_scene

    def make(seed):
        return KeyframeSearcher(
            "mem://synthetic-600s", heur, ["couch", "lamp"], ["tv"],
            search_budget=0.5, config=config, seed=seed, decoder=default_scene(600.0),
        )

    with environ(env or {}):
        make(seed=1).search()                      # warm-up: cuBLAS, the kernel library
        searcher = make(seed=0)
        log(f"[{label}] frame cache {tuple(searcher.cache.frames.shape)} uint8 "
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
    st = searcher.step_stats
    counted = {"frames": 16 * st.steps + sum(st.verify_widths), "grid": st.steps,
               "verify_batches": list(st.verify_widths)}

    state = searcher._final_state
    scores = searcher.score_distribution
    forwards = counted["grid"] + len(counted["verify_batches"])

    def expected(n):
        grid_n, verify_n = n if isinstance(n, tuple) else (n, n)
        return grid_n * counted["grid"] + verify_n * len(counted["verify_batches"])

    checks = {
        "8 timestamps": len(stamps) == 8 and len(frames) == 8,
        "timestamps in range": all(0 <= t < searcher.duration for t in stamps),
        "timestamps sorted": stamps == sorted(stamps),
        "finite scores": bool(torch.isfinite(state.scores).all()) and len(scores) == 600,
        "frames at native size": all(f.shape == (360, 640, 3) for f in frames),
        "stepped through CUDA graphs": st.replays > 0 and st.host_reads == 2 * st.steps,
        **{f"{k} launched {n} per (grid, verify) forward": counts[k] == expected(n)
           for k, n in per_forward.items()},
    }
    log(f"[{label}] iterations={state.iteration} frames_scored={counted['frames']} "
        f"wall={wall:.3f} s peak_mem={peak / 2**20:.1f} MiB; {st.host_reads / st.steps:.2f} "
        f"host reads, {st.replays / st.steps:.2f} graph replays a step ({st.captures} "
        f"captures)  ({card})")
    log(f"[{label}] detector forwards: {counted['grid']} grid (B=1), verify batches "
        f"{counted['verify_batches']}")
    log(f"[{label}] timestamps={stamps} remaining={searcher.remaining_targets}")
    log(f"[{label}] kernel launches during the search: {counts}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"{label} checks failed: {failed}")
    return counts, counted


def phase_slice(torch, card, heur):
    """Phase 5: the slice's main path; returns the launch counts."""
    from tstar_tpu_torch import SearchConfig

    cfg = SearchConfig(cache_hw=(192, 384))
    per_forward = launches(fused_mha_from_qkv=12, patch_embed_matmul=1, fused_layernorm=27)
    counts, _ = run_search(torch, card, heur, "slice", cfg, per_forward)
    return counts


def phase_knobs(torch, card, heur):
    """Phase 6: the same search under the detector's knobs; returns each
    run's launch counts."""
    from tstar_tpu_torch import SearchConfig

    base = dict(cache_hw=(192, 384))
    runs = {
        "int8+verify512": (SearchConfig(detector_quant="int8", verify_image_size=512, **base), None,
                           launches(fused_mha_from_qkv=12, patch_embed_matmul=1, w8a8_matmul=48)),
        "w8a16": (SearchConfig(detector_quant="w8a16", **base), None,
                  launches(fused_mha_from_qkv=12, patch_embed_matmul=1)),
        "ln_matmul": (SearchConfig(**base), {"TSTAR_LN_MATMUL": "force"},
                      launches(fused_mha_from_qkv=12, patch_embed_matmul=1, ln_matmul=24,
                               fused_layernorm=3)),
    }
    out = {}
    for label, (cfg, env, per_forward) in runs.items():
        if label == "int8+verify512":
            with w8a8_weights_read() as read:
                counts, counted = run_search(torch, card, heur, label, cfg, per_forward, env=env)
            check_weights_made_once(heur._weight_views[("int8", 512)], read, counts["w8a8_matmul"])
            if not counted["verify_batches"]:
                raise SystemExit("int8+verify512: no verification ran, the 512 tower was not driven")
        else:
            counts, _ = run_search(torch, card, heur, label, cfg, per_forward, env=env)
        out[label] = counts
    return out


@contextlib.contextmanager
def w8a8_weights_read():
    """Records the address of the (N, K) weight that each K4 launch reads."""
    from tstar_tpu_torch.kernels import quant_matmul

    read, launch = [], quant_matmul._launch

    def recording(x, w_i8, w_t, *rest):
        read.append(w_t.data_ptr())
        return launch(x, w_i8, w_t, *rest)

    quant_matmul._launch = recording
    try:
        yield read
    finally:
        quant_matmul._launch = launch


def check_weights_made_once(views, read, launched):
    """Every K4 launch of the int8 searches (warm-up and measured) read one of
    the 48 (N, K) copies that quantizing the tower made once for the
    heuristic's int8 weight views (the grid's and the verification's share
    them): no weight was transposed per call."""
    qvision, _, qverify = views
    held = {}
    for tree in (qvision, qverify):
        for lyr in tree["layers"]:
            for name in ("qkv", "o", "fc1", "fc2"):
                held[lyr[name]["wt"].data_ptr()] = lyr[name]["wt"]
    mb = sum(t.numel() * t.element_size() for t in held.values()) / 1e6
    # ``read`` holds the eager launches and the captured ones; a graph
    # replay launches the captured calls again, on the same weights
    ok = (len(held) == 48 and set(read) <= set(held) and len(set(read)) == 48
          and launched > 0 and read)
    log(f"[int8+verify512] K4 read {len(set(read))} distinct (N, K) weights in {len(read)} "
        f"launches made or captured by Python (warm-up and measured search; {launched} "
        f"launches in the measured one, graph replays included), all among the {len(held)} "
        f"copies made once per scorer ({mb:.1f} MB of device memory beside the (K, N) kernels): "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("int8+verify512: a K4 launch read a weight not made once per scorer")


def phase_routes(torch, card, heur):
    """Phase 7: the same search over the grid-input and attention routes;
    returns each run's launch counts."""
    from tstar_tpu_torch import SearchConfig

    base = dict(cache_hw=(192, 384))
    tower = dict(fused_mha_from_qkv=12, fused_layernorm=27)
    runs = {
        "k7 pallas preprocess": (
            SearchConfig(use_pallas_preprocess=True, **base), None,
            launches(build_detector_grid_pallas=(1, 0), patch_embed_matmul=1, **tower)),
        "k6 grid embed": (
            SearchConfig(**base), {"TSTAR_GRID_EMBED": "force"},
            launches(grid_cell_embed=(1, 0), patch_embed_matmul=(0, 1), **tower)),
        "k8 flash": (
            SearchConfig(**base), {"TSTAR_FUSED_MHA": "0", "TSTAR_FLASH_ATTENTION": "1"},
            launches(flash_mha=12, patch_embed_matmul=1, fused_layernorm=27)),
    }
    out = {}
    for label, (cfg, env, per_forward) in runs.items():
        counts, _ = run_search(torch, card, heur, label, cfg, per_forward, env=env)
        out[label] = counts
    return out


def phase_k6_trace(torch, card, heur):
    """Phase 7, last: the ``TSTAR_GRID_EMBED=force`` search traced through
    K6 and through K6's plain version on the card (the same canvas values,
    cuBLAS's sums): where K6's summation order moves the search, the grid
    forwards that sampled the same seconds, the largest score difference on
    them and at the last of them (whose difference set the next sample),
    and each search's verification batches and keyframes."""
    from tstar_tpu_torch.kernels import grid_embed
    from tstar_tpu_torch.tools.profile_search import _same_seconds, _traced_search, environ

    launch = grid_embed._launch

    def plain(cache, secs, awk, bias, ah, w, grid_shape, cell_hw, p):
        return grid_embed.grid_cell_embed_plain(
            cache, secs, awk, bias, ah, w, grid_shape=grid_shape, cell_hw=cell_hw, patch_size=p)

    runs = {}
    with environ({"TSTAR_GRID_EMBED": "force"}):
        for label, body in (("K6 kernel", launch), ("K6 plain version", plain)):
            grid_embed._launch = body
            try:
                runs[label] = _traced_search(heur)
            finally:
                grid_embed._launch = launch
    for label, r in runs.items():
        log(f"[k6 trace] {label}: {len(r['grid'])} grid forwards, verify batches "
            f"{r['verify_batches']}, keyframes {r['keyframes']}")
    a, b = runs["K6 kernel"], runs["K6 plain version"]
    same = _same_seconds(a, b)
    n = same["forwards"]
    last = (a["grid"][n - 1][1] - b["grid"][n - 1][1]).abs().max().item() if n else float("nan")
    log(f"[k6 trace] K6 kernel / its plain version: the first {n} of {same['of']} grid forwards "
        f"sampled the same seconds; largest score difference on them "
        f"{same['max_score_diff']:.3e}, on the last of them {last:.3e}"
        + ("; the searches sample the same seconds throughout"
           if n == same["of"] and len(a["grid"]) == len(b["grid"]) else
           f"; grid forward {n + 1} sampled other seconds") + f"  ({card})")
    if n == 0 or not all(torch.isfinite(c).all() for _, c in a["grid"]):
        raise SystemExit("K6 route: the kernel's search parts from its plain version at once")


def _batched_tasks(n=8):
    from tstar_tpu_torch.parallel.multi_video import VideoTask
    from tstar_tpu_torch.video.synthetic import scene_variant

    return [VideoTask(f"mem://synthetic-600s-{i}", ["couch", "lamp"], ["tv"], seed=i,
                      decoder=scene_variant(i)) for i in range(n)]


def _per_video(stats, i):
    """Video ``i``'s sampled seconds, one (16,) list per step it was active."""
    return [e["secs"][i].tolist() for e in stats.trace if e["active"][i]]


def phase_batched(torch, card, heur):
    """Phase 8: the batched multi-video search at B = 8 (module docstring).
    Returns the graph-stepped run's launch counts."""
    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.kernels import grid_embed, launch_counts, reset_launch_counts
    from tstar_tpu_torch.ops.sampling import uniform_stride_indices
    from tstar_tpu_torch.parallel.batched import stack_scorers
    from tstar_tpu_torch.parallel.multi_video import search_videos
    from tstar_tpu_torch.search.engine import run_search
    from tstar_tpu_torch.search.state import init_state, stack_states
    from tstar_tpu_torch.search.step_graphs import StepStats, Stepper
    from tstar_tpu_torch.tools.profile_search import environ
    from tstar_tpu_torch.video.cache import build_frame_cache

    cfg = SearchConfig(cache_hw=(192, 384), search_budget=0.5)
    tower = dict(fused_mha_from_qkv=12, fused_layernorm=27)
    # search_videos builds each video's scorer inside the counted run: its
    # prompts go through the text tower once (K3 for each LayerNorm, no K1)
    per_scorer = {"fused_layernorm": 2 * heur.model.cfg.text.num_layers + 1}

    def batched(graphs, label, per_forward, env=None):
        """One warm-up and one measured ``search_videos`` of the eight tasks."""
        with environ(env or {}):
            search_videos(_batched_tasks(), heur, cfg, graphs=graphs)       # warm-up
            tasks, stats = _batched_tasks(), StepStats(record=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            results = search_videos(tasks, heur, cfg, graphs=graphs, stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        active = sum(sum(e["active"]) for e in stats.trace)
        frames = 16 * active + sum(stats.verify_widths)
        grid, verify = stats.steps, len(stats.verify_widths)

        def expected(k, n):
            g, v = n if isinstance(n, tuple) else (n, n)
            return g * grid + v * verify + 8 * per_scorer.get(k, 0)

        checks = {
            "8 keyframes each": all(len(r["keyframe_secs"]) == 8 for r in results),
            "keyframes in range": all(0 <= s < 600 for r in results for s in r["keyframe_secs"]),
            "finite distributions": all(
                all(map(lambda x: x == x and abs(x) < 1e30, r["keyframe_distribution"]))
                for r in results),
            "two host reads a step": stats.host_reads == 2 * stats.steps,
            **({"stepped through CUDA graphs": stats.replays > 0} if graphs else
               {"no graph": stats.replays == 0 and stats.captures == 0}),
            **{f"{k} launched {n} per (grid, verify) forward": counts[k] == expected(k, n)
               for k, n in per_forward.items()},
        }
        log(f"[{label}] B=8 x 600 s: {stats.steps} steps, {grid} grid forwards of 8 images, "
            f"{verify} verify forwards of {sorted(set(stats.verify_widths))} images; iterations "
            f"{[r['iterations'] for r in results]}; frames_scored={frames} wall={wall:.3f} s "
            f"({frames / wall:.1f} frames/s, decode and upload of the 8 caches included) "
            f"peak_mem={peak / 2**20:.1f} MiB; {stats.host_reads / stats.steps:.2f} host reads, "
            f"{stats.replays / stats.steps:.2f} graph replays a step ({stats.captures} "
            f"captures)  ({card})")
        log(f"[{label}] kernel launches during the search: {counts}")
        failed = [k for k, v in checks.items() if not v]
        if failed:
            raise SystemExit(f"{label} checks failed: {failed}")
        return results, stats, counts

    per_forward = launches(patch_embed_matmul=1, **tower)
    res_g, st_g, counts = batched(True, "batched", per_forward)
    res_e, st_e, _ = batched(False, "batched eager", per_forward)
    # (a) graph-stepped == eager, video by video
    same = all(
        _per_video(st_g, i) == _per_video(st_e, i)
        and all(res_g[i][k] == res_e[i][k] for k in ("keyframe_secs", "iterations",
                                                      "remaining_targets"))
        for i in range(8)
    )
    log(f"[batched] graphs vs graphs=False: every video's seconds per iteration, keyframes, "
        f"iterations and remaining targets equal: {same}; remaining "
        f"{[r['remaining_targets'] for r in res_g]} {'OK' if same else 'FAIL'}")
    if not same:
        raise SystemExit("batched search: the graph-stepped driver differs from the eager one")

    # (c) each video's first grid forward in the batch against its single-video one
    tasks = _batched_tasks()
    caches = [build_frame_cache(t.video_path, cfg, device="cuda", decoder=t.decoder) for t in tasks]
    scorers = [heur.build_scorer(c.frames, t.target_objects, t.cue_objects, cfg)
               for c, t in zip(caches, tasks)]
    with torch.no_grad():
        first = uniform_stride_indices(caches[0].n_valid, 16, device="cuda")
        singles = torch.stack([sc.score_grid(first)[0].float() for sc in scorers])
    in_batch = st_g.trace[0]["conf"].float()
    diff = (in_batch - singles).abs().max().item()
    ok = diff <= 2e-2 and bool(torch.isfinite(in_batch).all())
    log(f"[batched] first iteration's grid confidences, batch of 8 vs each video alone: max "
        f"|diff| {diff:.3e} (tol 2e-2, phase 4's: the batch of 8 takes other kernel "
        f"configurations) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("batched search: the batch's grid scores differ from the single video's")

    # (b) the single-video main path through graphs == eager
    runs = {}
    for graphs in (True, False):
        state = init_state(caches[0].n_valid, 2, cfg,
                           torch.Generator(device="cuda").manual_seed(0),
                           n_pad=caches[0].n_pad, device="cuda")
        stats = StepStats(record=True)
        final, secs = run_search(state, scorers[0], cfg, graphs=graphs, stats=stats)
        runs[graphs] = (_per_video(stats, 0), secs.tolist(), final.iteration,
                        final.remaining.tolist(), stats)
    a, b = runs[True], runs[False]
    ok = a[:4] == b[:4] and a[4].replays > 0 and b[4].replays == 0
    log(f"[single] run_search with graphs vs graphs=False: {a[2]} iterations, keyframes "
        f"{a[1]}, seconds per iteration, keyframes, iterations and remaining equal: "
        f"{a[:4] == b[:4]}; {a[4].replays / a[4].steps:.2f} graph replays and "
        f"{a[4].host_reads / a[4].steps:.2f} host reads a step {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("run_search: the graph-stepped search differs from the eager one")

    # (e) no synchronization inside the phases: one eager grid step and its
    # verification rounds, batched (flat) and single (adaptive wide), twice
    # (iteration 0, then a sampling one), the two designated reads outside
    g8 = [torch.Generator(device="cuda").manual_seed(i) for i in range(8)]
    states = stack_states([
        init_state(c.n_valid, 2, cfg, g, n_pad=c.n_pad, device="cuda") for c, g in zip(caches, g8)
    ])
    st8 = Stepper.batched(states, stack_scorers(scorers, cfg), cfg, graphs=False)
    st1 = Stepper.single(init_state(caches[0].n_valid, 2, cfg,
                                    torch.Generator(device="cuda").manual_seed(0),
                                    n_pad=caches[0].n_pad, device="cuda"),
                         scorers[0], cfg, graphs=False)
    torch.cuda.synchronize()
    phases = 0
    with torch.no_grad():
        for stp, verify in ((st8, ("round",)), (st1, ("wide", "round"))):
            for it in range(2):
                first_rows = stp.iteration == 0 if it == 0 else None
                draw = [it > 0] * stp.b
                torch.cuda.set_sync_debug_mode("error")
                try:
                    stp._phase_a(first_rows, draw)
                    for v in verify:
                        (stp._phase_round if v == "round" else stp._phase_wide)()
                    stp._phase_c()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                phases += 2 + len(verify)
    torch.cuda.synchronize()
    log(f"[sync] {phases} eager phases (grid steps of B=8 and B=1 at iterations 0 and 1, "
        f"their verification rounds and wide rescore, commits) raised nothing under "
        f"torch.cuda.set_sync_debug_mode('error') OK")

    # (f) K6's gate opens at the batch of 8
    with environ({"TSTAR_GRID_EMBED": "1"}):
        opens = grid_embed.use_grid_embed_kernel((8, 640, 192, 384, 3), 768, 32, 768, cfg)
        closed = not grid_embed.use_grid_embed_kernel((1, 640, 192, 384, 3), 768, 32, 768, cfg)
    log(f"[k6 gate] TSTAR_GRID_EMBED=1: use_grid_embed_kernel opens at an image batch of 8 "
        f"(rule: batch >= {grid_embed._MIN_BATCH}): {opens}; closed at 1: {closed}")
    _, _, k6 = batched(True, "batched k6", launches(
        grid_cell_embed=(1, 0), patch_embed_matmul=(0, 1), **tower), env={"TSTAR_GRID_EMBED": "1"})
    if not (opens and closed and k6["grid_cell_embed"] > 0):
        raise SystemExit("K6's gate did not open at the batch of 8")
    return counts, k6


# ---------------------------------------------------------------------------
# Phase 9: the VLM stages
# ---------------------------------------------------------------------------

QA_QUESTION = "What color is the couch in the video?"
QA_OPTIONS = "A) red\nB) blue\nC) green\nD) yellow"


def byte_tokenizer(directory: str, special: Optional[Dict[str, int]] = None):
    """A byte-level Qwen tokenizer (``write_byte_vocab``): the repo ships
    no vocabulary."""
    from tstar_tpu_torch.models.qwen_tokenizer import QwenTokenizer, write_byte_vocab

    write_byte_vocab(directory, special)
    return QwenTokenizer.from_dir(directory)


def to_device(torch, inp, dev):
    """``prepare_*_inputs``' host arrays -> ``prefill``'s tensors on ``dev``."""
    out = {k: torch.as_tensor(inp[k], dtype=torch.int64).to(dev)
           for k in ("input_ids", "prompt_lens", "position_ids")}
    out["image_patches"] = (None if inp["image_patches"] is None
                            else torch.from_numpy(inp["image_patches"]).to(dev))
    return out


def vlm_work(model, frames: int, prompt: int, new: int):
    """(SigLIP ops, prefill ops, decode bytes a token) that LLaVA-OneVision
    needs for ``frames`` frames, a ``prompt``-token prompt and ``new``
    tokens: every product's multiply-adds (x2), causal attention counted on
    its lower triangle; a decode step reads the language model's weights
    (one row of the embedding table) and the cache so far, once."""
    cfg = model.cfg
    v, t = cfg.vision, cfg.text
    p = v.num_patches
    rows = frames * p
    d, i = v.hidden_size, v.intermediate_size
    siglip = 2 * rows * (v.patch_size ** 2 * 3) * d + v.num_layers * (
        2 * rows * (4 * d * d + 2 * d * i) + 4 * frames * p * p * d)
    h, kv = t.hidden_size, t.num_kv_heads * t.head_dim
    layer = 2 * prompt * (2 * h * h + 2 * h * kv + 3 * h * t.intermediate_size)
    attn = 2 * prompt * (prompt + 1) * h
    proj = 2 * rows * (d * h + h * h)
    prefill = siglip + proj + t.num_layers * (layer + attn) + 2 * h * t.vocab_size
    lm = sum(prm.numel() for name, prm in model.named_parameters()
             if not name.startswith(("vision_tower", "projector", "image_newline", "embed_tokens")))
    es = model.dtype.itemsize
    cache = t.num_layers * 2 * (prompt + new) * kv * es
    return siglip, prefill, (lm + h) * es + cache


def vlm_7b(torch, card):
    """LLaVA-OneVision at 7B's widths, seeded on the card in bf16, and a
    byte-level tokenizer: phase 9a's model, which phase 11 uses again."""
    import tempfile

    from tstar_tpu_torch.models.llava_onevision import LlavaOnevisionConfig, LlavaOnevisionModel
    from tstar_tpu_torch.models.qwen2vl import random_model

    cfg = LlavaOnevisionConfig()
    t0 = time.perf_counter()
    model = random_model(LlavaOnevisionModel, cfg, torch.bfloat16, "cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[vlm] LLaVA-OneVision at 7B widths (SigLIP 1152 x 27, Qwen2 3584 x 28, vocab "
        f"{cfg.text.vocab_size}): {n_params / 1e9:.3f} B parameters, "
        f"{n_params * 2 / 1e9:.2f} GB bf16, seeded on the card in {time.perf_counter() - t0:.2f} s "
        f"({card})")
    with tempfile.TemporaryDirectory() as tmp:
        tok = byte_tokenizer(tmp)
    return model, tok


def vlm_full_width(torch, card, model, tok):
    """Phase 9a: one QA request at LLaVA-OneVision-7B's widths, bf16, with
    graphs and eager; a second request of the same bucket, sent through
    ``UniversalGrounder.inference_qa`` on the same model; K3 54 times a
    request, no other kernel; a replay under the sync debug mode."""
    from tstar_tpu_torch.grounding.prompts import build_qa_prompt
    from tstar_tpu_torch.grounding.universal import UniversalGrounder
    from tstar_tpu_torch.grounding.vlm_backend import TorchVLMBackend
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.models.generate import GenerateStats, generate
    from tstar_tpu_torch.models.llava_onevision import prepare_llava_inputs
    from tstar_tpu_torch.utils.images import load_video_frames
    from tstar_tpu_torch.video.synthetic import default_scene, scene_variant

    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    prompt = build_qa_prompt(QA_QUESTION, QA_OPTIONS, 8)
    eos = [tok.eos_id, tok.pad_id]

    def request(decoder, graphs, stats):
        """One QA request as the grounder makes it -> (tokens, seconds, inputs)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        frames = load_video_frames("mem://scene", 8, decoder=decoder)
        inp = prepare_llava_inputs(tok, prompt, frames, cfg)
        out = generate(model, inp["input_ids"], inp["prompt_lens"], inp["position_ids"],
                       max_new_tokens=30, eos_token_ids=eos, temperature=0.0,
                       image_patches=inp["image_patches"], graphs=graphs, stats=stats).tolist()
        return out, time.perf_counter() - t, inp

    stats = GenerateStats(timed=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    graph_tokens, first_s, inp = request(default_scene(600.0), None, stats)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    eager = GenerateStats(timed=True)
    eager_tokens, eager_s, _ = request(default_scene(600.0), False, eager)
    captures = stats.captures
    # the second request of the bucket goes in as a user's does: the
    # grounder's inference_qa -> the backend (its own stats and decode)
    backend = TorchVLMBackend.from_model(model, tok)
    backend.stats = GenerateStats(timed=True)
    grounder = UniversalGrounder("llava-onevision-7b", backend=backend)
    torch.cuda.synchronize()
    t = time.perf_counter()
    reset_launch_counts()
    frames2 = load_video_frames("mem://scene", 8, decoder=scene_variant(3))
    answer = grounder.inference_qa(frames2, QA_QUESTION, QA_OPTIONS, temperature=0.0)
    second_counts = launch_counts()
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t
    inp2 = prepare_llava_inputs(tok, prompt, frames2, cfg)
    s = int(inp["prompt_lens"][0])
    others = {k: v for c in (counts, second_counts) for k, v in c.items()
              if k != "fused_layernorm" and k not in DECODE_KERNELS and v}
    ok = (graph_tokens == eager_tokens and captures == 1 and backend.stats.captures == 0
          and backend.stats.replays >= 1 and isinstance(answer, str)
          and counts["fused_layernorm"] == 54 == second_counts["fused_layernorm"] and not others
          and decode_launches(counts, stats.decode_steps)
          and decode_launches(second_counts, backend.stats.decode_steps)
          and fused_layers(stats) == 28 == fused_layers(backend.stats)
          and len(graph_tokens[0]) == 30 and int(inp2["prompt_lens"][0]) == s)
    decode = (f"decode kernels {[counts[k] for k in DECODE_KERNELS]} / "
              f"{[second_counts[k] for k in DECODE_KERNELS]} in {stats.decode_steps} / "
              f"{backend.stats.decode_steps} steps (want 57, 28, 28 a step), layers on them "
              f"{fused_layers(stats)} / {fused_layers(backend.stats)} (want 28)")
    stats = backend.stats
    log(f"[vlm] QA request, 8 frames of a synthetic 600 s video, prompt {s} tokens "
        f"({8 * cfg.tokens_per_frame + 1} video), 30 new tokens, greedy: graph tokens == eager "
        f"tokens: {graph_tokens == eager_tokens} ({graph_tokens[0][:6]}...); captures: first "
        f"request {captures}, second request of the bucket (UniversalGrounder.inference_qa, "
        f"answer {answer[:24]!r}) {stats.captures}; K3 launches {counts['fused_layernorm']} / "
        f"{second_counts['fused_layernorm']} a request (want 54), {decode}, other kernels "
        f"{others or 'none'} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 9a: the full-width VLM request failed its checks")

    # a replay synchronizes nothing (the flag read is outside it)
    (bucket,) = [b for b in model._decode_buckets.values() if "step" in b.graphs]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        bucket.run_step(GenerateStats())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("[vlm] a decode replay raised nothing under torch.cuda.set_sync_debug_mode('error') OK")

    # times: SigLIP alone, and the prefill / decode of the second request
    dev = to_device(torch, inp2, "cuda")
    pixels = dev["image_patches"]
    siglip_ms = cuda_ms(lambda: model.vision_tower(pixels), iters=5, warmup=1)
    siglip_ops, prefill_ops, step_bytes = vlm_work(model, 8, s, 30)
    prefill_ms, decode_ms = stats.prefill_ms[-1], stats.decode_ms[-1]
    steps = 29
    tok_s = steps / (decode_ms / 1e3)
    b_siglip = siglip_ops / PEAK_OPS_PER_S["bf16"] * 1e3
    b_prefill = prefill_ops / PEAK_OPS_PER_S["bf16"] * 1e3
    b_step = step_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[vlm] SigLIP (8 frames, 5832 x 1152) {siglip_ms:.3f} ms (bound {b_siglip:.3f} ms, "
        f"{siglip_ops / 1e12:.3f} TFLOP); prefill {prefill_ms:.3f} ms = "
        f"{s / prefill_ms * 1e3:.1f} prompt tokens/s (bound {b_prefill:.3f} ms, "
        f"{prefill_ops / 1e12:.3f} TFLOP); decode {decode_ms:.3f} ms for {steps} steps = "
        f"{tok_s:.1f} tokens/s per sequence, {decode_ms / steps:.3f} ms a token (bound "
        f"{b_step:.3f} ms: {step_bytes / 1e9:.2f} GB a token; {1e3 / b_step:.1f} tokens/s); "
        f"request {second_s:.4f} s (bound {(b_prefill + steps * b_step) / 1e3:.4f} s: prefill "
        f"and decode; first, capturing: {first_s:.4f} s; eager: {eager_s:.4f} s, eager decode "
        f"{eager.decode_ms[-1]:.3f} ms); graph captures {captures + stats.captures} (one "
        f"bucket: 1), replays {stats.replays}, host reads {stats.flag_reads} in "
        f"{stats.decode_steps} steps of the grounder's request; "
        f"peak memory {peak / 1e9:.2f} GB (weights {n_params * 2 / 1e9:.2f} GB) ({card})")
    row = {"siglip_ms": siglip_ms, "siglip_bound_ms": b_siglip, "prefill_ms": prefill_ms,
           "prefill_bound_ms": b_prefill, "prefill_tokens_per_s": s / prefill_ms * 1e3,
           "decode_ms_per_token": decode_ms / steps, "decode_bound_ms_per_token": b_step,
           "decode_tokens_per_s": tok_s, "request_s": second_s, "first_request_s": first_s,
           "eager_request_s": eager_s, "eager_decode_ms": eager.decode_ms[-1],
           "request_bound_s": (b_prefill + steps * b_step) / 1e3,
           "captures": captures + stats.captures, "peak_gb": peak / 1e9,
           "prompt_tokens": s, "k3_launches_per_request": counts["fused_layernorm"]}
    del bucket, dev, pixels, backend, grounder
    return row


def vlm_numerics(torch, card):
    """Phase 9b: full widths at reduced depth (2 vision and 2 decoder layers,
    2 frames): the prefill's next-token logits in bf16 on the card against the
    same weights in f32 on the CPU, for LLaVA-OneVision and Qwen2-VL."""
    import tempfile

    from tstar_tpu_torch.grounding.prompts import build_qa_prompt
    from tstar_tpu_torch.models.generate import bucket_len, prefill
    from tstar_tpu_torch.models.llava_onevision import (
        LlavaOnevisionConfig, LlavaOnevisionModel, prepare_llava_inputs,
    )
    from tstar_tpu_torch.models.qwen2vl import Qwen2VLConfig, Qwen2VLModel, random_model
    from tstar_tpu_torch.models.qwen2vl_processor import prepare_vlm_inputs
    from tstar_tpu_torch.utils.images import load_video_frames
    from tstar_tpu_torch.video.synthetic import default_scene

    with tempfile.TemporaryDirectory() as tmp:
        tok = byte_tokenizer(tmp)
    frames = load_video_frames("mem://scene", 2, decoder=default_scene(600.0))
    prompt = build_qa_prompt(QA_QUESTION, QA_OPTIONS, 2)
    llava = LlavaOnevisionConfig()
    llava = dataclasses.replace(llava, vision=dataclasses.replace(llava.vision, num_layers=2),
                                text=dataclasses.replace(llava.text, num_layers=2))
    qwen = Qwen2VLConfig()
    qwen = dataclasses.replace(qwen, vision=dataclasses.replace(qwen.vision, depth=2),
                               text=dataclasses.replace(qwen.text, num_layers=2))
    runs = {
        "LLaVA-OneVision (SigLIP 1152, Qwen2 3584)": (
            LlavaOnevisionModel, llava, prepare_llava_inputs(tok, prompt, frames, llava)),
        "Qwen2-VL (vision 1280, Qwen2 3584)": (
            Qwen2VLModel, qwen, prepare_vlm_inputs(tok, prompt, frames, qwen.vision)),
    }
    # bf16 keeps 8 significant bits (unit roundoff 2^-9 ~ 2e-3).  From the
    # pixels to the logits a value is rounded at ~20 points in series (2 x 6
    # in the vision layers, projector or merger, pooling, 2 x 7 in the
    # decoder layers, the final norm, the LM head), each adding a relative
    # error of up to 2^-9 of the value it rounds; summed in quadrature over a
    # few thousand random-signed terms per product that stays ~sqrt(20) x
    # 2^-9 ~ 1e-2 of the signal's scale, and the worst of 152k logits sits
    # some 4 sigma out: 4e-2 of the largest logit, rounded up to 5e-2.
    tol = 5e-2
    for label, (cls, cfg, inp) in runs.items():
        gpu = random_model(cls, cfg, torch.float32, "cuda", seed=1)
        with torch.device("meta"):
            cpu = cls(cfg)
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, assign=True)
        gpu = gpu.to(torch.bfloat16)
        max_len = bucket_len(int(inp["prompt_lens"][0]) + 1)
        grid = inp["image_grid_hw"]
        want, _ = prefill(cpu.eval(), *to_device(torch, inp, "cpu").values(), grid, max_len)
        got, _ = prefill(gpu, *to_device(torch, inp, "cuda").values(), grid, max_len)
        got = got.float().cpu()
        diff = (got - want).abs().max().item()
        scale = want.abs().max().item()
        rel = ((got - want).norm() / want.norm()).item()
        top = bool(got.argmax() == want.argmax())
        ok = diff <= tol * scale and bool(got.isfinite().all()) and got.shape == want.shape
        log(f"[vlm numerics] {label}, 2 + 2 layers, 2 frames, prompt {int(inp['prompt_lens'][0])} "
            f"tokens: next-token logits cuda-bf16 vs cpu-f32 max |diff| {diff:.4e} (tol "
            f"{tol:.0e} x max |ref| = {tol * scale:.4e}), relative L2 {rel:.3e}, same argmax "
            f"{top} {'OK' if ok else 'FAIL'} ({card})")
        if not ok:
            raise SystemExit(f"phase 9b: {label} on the card disagrees with the CPU")
        del gpu, cpu
        torch.cuda.empty_cache()


def vlm_facade(torch, card, models=None, special=None):
    """Phase 9c: a tiny checkpoint of each family written here (config.json,
    byte vocabulary, model.safetensors), loaded through ``UniversalGrounder``
    onto the card and onto the CPU in f32: at temperature 0 the QA, grounding
    and (Qwen2-VL) batched QA strings agree, and the batch equals the serial
    calls.  ``models`` / ``special``: other tiny models and their
    vocabulary's special ids (phase 13d).  The frames' pixel cap is a 2 x 2
    grid of the tower's merge units or, for a windowed tower, its windows
    (LLaVA's preprocessing takes no cap)."""
    import tempfile

    import numpy as np

    from tstar_tpu_torch.grounding.universal import UniversalGrounder
    from tstar_tpu_torch.models.loader import save_vlm_checkpoint
    from tstar_tpu_torch.video.synthetic import default_scene

    if models is None:
        models, special = tiny_vlms(torch)
    scene = default_scene(600.0)
    rng = np.random.default_rng(0)
    items = [{"frames": [rng.integers(0, 256, (360, 640, 3), np.uint8) for _ in range(2)],
              "question": f"What {'is it ' * i}?", "options": QA_OPTIONS} for i in range(4)]
    for family, model in models.items():
        with tempfile.TemporaryDirectory() as d:
            save_vlm_checkpoint(model, d)
            byte_tokenizer(d, special)
            answers = {}
            for device in ("cuda", "cpu"):
                g = UniversalGrounder(f"{family}-tiny", model_path=d, device=device,
                                      dtype=torch.float32)
                g.backend.max_pixels = facade_pixels(model.cfg.vision)
                try:
                    grounding = g.inference_query_grounding(
                        "mem://scene", QA_QUESTION, QA_OPTIONS, temperature=0.0, max_tokens=32,
                        decoder=scene)
                except ValueError as e:          # the 2-line parse, after its re-prompt
                    grounding = f"{type(e).__name__}: {e}"
                qa = g.inference_qa(items[0]["frames"], QA_QUESTION, QA_OPTIONS, temperature=0.0)
                serial = [g.inference_qa(it["frames"], it["question"], it["options"],
                                         temperature=0.0) for it in items]
                batch = g.inference_qa_batch(items, temperature=0.0)
                answers[device] = (qa, grounding, serial, batch)
        a = answers["cuda"]
        ok = a == answers["cpu"] and a[2] == a[3]
        log(f"[vlm facade] {family}: checkpoint written and loaded through UniversalGrounder; "
            f"cuda == cpu (f32, temperature 0) for QA {a[0]!r}, grounding {str(a[1])[:60]!r}..., "
            f"QA batch of 4: {ok and a == answers['cpu']}; batch == serial: {a[2] == a[3]} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"vlm facade: the {family} grounder on the card differs from the CPU")


def facade_pixels(vision) -> int:
    """Phase 9c's pixel cap for a tiny tower (``vlm_facade``)."""
    unit = getattr(vision, "window_size", None)
    if unit is None:
        unit = vision.patch_size * getattr(vision, "spatial_merge_size", 1)
    return (2 * unit) ** 2


def tiny_vlms(torch):
    """Phase 9c's tiny Qwen2-VL and LLaVA-OneVision, seeded, and the special
    token ids of their byte-level vocabulary."""
    from tstar_tpu_torch.models.llava_onevision import LlavaOnevisionConfig, LlavaOnevisionModel
    from tstar_tpu_torch.models.qwen2vl import (
        Qwen2VLConfig, Qwen2VLModel, Qwen2VLTextConfig, Qwen2VLVisionConfig, init_random_,
    )
    from tstar_tpu_torch.models.qwen_tokenizer import SPECIAL_TOKENS
    from tstar_tpu_torch.models.siglip import SiglipVisionConfig

    special = {t: 256 + i for i, t in enumerate(SPECIAL_TOKENS)}
    text = dict(vocab_size=300, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
                intermediate_size=64, rope_theta=10000.0)
    models = {
        "qwen": Qwen2VLModel(Qwen2VLConfig(
            vision=Qwen2VLVisionConfig(depth=2, embed_dim=16, num_heads=2, mlp_ratio=2.0,
                                       hidden_size=32),
            text=Qwen2VLTextConfig(**text, mrope_section=(1, 1, 2)),
            image_token_id=special["<|image_pad|>"], video_token_id=special["<|video_pad|>"],
            vision_start_token_id=special["<|vision_start|>"])),
        "llava": LlavaOnevisionModel(LlavaOnevisionConfig(
            vision=SiglipVisionConfig(hidden_size=16, num_layers=2, num_heads=2,
                                      intermediate_size=32, patch_size=2, image_size=8),
            text=Qwen2VLTextConfig(**text, mrope_section=(4, 0, 0)),
            image_token_id=264, video_token_id=265)),
    }
    for model in models.values():
        init_random_(model, torch.Generator().manual_seed(3))
    return models, special


def phase_vlm(torch, card):
    """Phase 9: the VLM stages (a) at full width, (b) numerics, (c) the
    facade.  Returns (9a's numbers, 9a's model and tokenizer for phase 11)."""
    t0 = time.perf_counter()
    with torch.no_grad():
        model, tok = vlm_7b(torch, card)
        row = vlm_full_width(torch, card, model, tok)
        gc.collect()
        torch.cuda.empty_cache()
        vlm_numerics(torch, card)
        vlm_facade(torch, card)
    log(f"[vlm] phase 9 wall {time.perf_counter() - t0:.1f} s ({card})")
    return row, (model, tok)


# ---------------------------------------------------------------------------
# Phase 10: YOLO-World v2-XL, the NMS kernel, checkpoints
# ---------------------------------------------------------------------------

YOLO_TARGETS, YOLO_CUES = ["couch", "lamp"], ["tv"]


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def nms_inputs(torch, b, n=8400, classes=80, seed=0, threshold=0.12):
    """Seeded boxes on a 640^2 canvas, 80 classes, scores on 20 levels (so
    ties), thresholded as ``postprocess_yolo`` does; image 1 of a batch has
    every score at or below the threshold."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    cxy = torch.rand(b, n, 2, generator=g, device="cuda") * 640
    wh = torch.rand(b, n, 2, generator=g, device="cuda") * 120 + 8
    boxes = torch.cat([cxy - wh / 2, cxy + wh / 2], dim=-1)
    cls = torch.randint(0, classes, (b, n), generator=g, device="cuda", dtype=torch.int32)
    scores = torch.floor(torch.rand(b, n, generator=g, device="cuda") * 20) / 20
    if b > 1:
        scores[1] *= threshold
    return boxes, torch.where(scores > threshold, scores, torch.zeros_like(scores)), cls


def nms_needed_ious(torch, order, keep, valid, n, max_out):
    """The IoUs the greedy loop needs on these inputs: each survivor's
    against the rows after it, up to the last row the loop had to reach (the
    max_out-th survivor, else the last row)."""
    rank = torch.argsort(order, dim=1)
    total = 0
    for r, k, v in zip(rank, keep.long(), valid):
        pos = sorted(r[k[v]].tolist())
        last = pos[-1] if len(pos) == max_out else n - 1
        total += sum(last - p for p in pos)
    return total


def phase_nms(torch, card):
    """Phase 10a: the NMS kernel against its plain version on the card, at
    N = 8,400 (a 640^2 image's anchors), B = 1 and 8; then postprocess_yolo
    through each.  Returns the summary rows."""
    from tstar_tpu_torch.kernels import nms as knms
    from tstar_tpu_torch.models.yoloworld import postprocess_yolo
    from tstar_tpu_torch.ops import nms as onms

    props = ptxas_props()
    regs = {k: v for k, v in props.items() if "nms_" in k}
    for name, p in sorted(regs.items()):
        log(f"[nms] {name}: {p.get('registers')} registers, {p.get('spills')} bytes spilled")
    rows = []
    for b, max_out in ((1, 50), (8, 50), (1, 8400)):
        boxes, scores, cls = nms_inputs(torch, b)
        keep_k, valid_k = onms.batched_class_nms(boxes, scores, cls, 0.7, max_out)
        with patched(onms, "greedy_nms", knms.greedy_nms_plain):
            keep_p, valid_p = onms.batched_class_nms(boxes, scores, cls, 0.7, max_out)
        torch.cuda.synchronize()
        equal = torch.equal(keep_k, keep_p) and torch.equal(valid_k, valid_p)
        # the kernel alone, on the class-offset boxes and the order it is given
        span = boxes.amax(dim=(-2, -1), keepdim=True) - boxes.amin(dim=(-2, -1), keepdim=True) + 1
        off = (boxes + cls.float()[..., None] * span).contiguous()
        order = torch.argsort(-scores, dim=-1, stable=True)
        ms = cuda_ms(lambda: knms.greedy_nms(off, order, 0.7, max_out))
        plain_ms = cuda_ms(lambda: knms.greedy_nms_plain(off, order, 0.7, max_out), iters=2, warmup=1)
        ious = nms_needed_ious(torch, order, keep_k, valid_k, 8400, max_out)
        n_bytes = b * 8400 * (16 + 8) + b * max_out * 5
        b_ms, b_by = bound_ms(n_bytes, 14 * ious, "f32")
        kept = valid_k.sum(dim=1).tolist()
        log(f"[nms] B={b} N=8400 80 classes max_outputs={max_out}: keep/valid equal to the plain "
            f"version: {equal}; kept {kept}; kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
            f"bound={b_ms:.5f} ms ({b_by}: {ious} IoUs needed x 14 f32 ops, {n_bytes / 1e6:.2f} "
            f"MB) library=none ({card}) {'OK' if equal else 'FAIL'}")
        if not equal:
            raise SystemExit(f"NMS kernel B={b} max_outputs={max_out} differs from its plain version")
        rows.append({"shape": f"B={b} N=8400 max_out={max_out}", "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "err": 0.0,
                     "registers": {k: v.get("registers") for k, v in regs.items()},
                     "spills": sum(v.get("spills", 0) for v in regs.values())})
    # postprocess_yolo through the kernel and through the plain version
    g = torch.Generator(device="cuda").manual_seed(1)
    logits = torch.randn(8, 8400, 16, generator=g, device="cuda") * 3 - 2
    boxes, _, _ = nms_inputs(torch, 8, seed=2)
    mask = torch.arange(16, device="cuda") < 4
    got = postprocess_yolo(logits, boxes, mask)
    with patched(onms, "greedy_nms", knms.greedy_nms_plain):
        want = postprocess_yolo(logits, boxes, mask)
    v = got[3]
    same = torch.equal(v, want[3]) and all(torch.equal(a[v], w[v]) for a, w in zip(got[:3], want[:3]))
    log(f"[nms] postprocess_yolo at B=8 x 8,400 anchors x 16 prompts (4 real): valid, and the "
        f"scores, classes and boxes at valid slots equal through the kernel and the plain "
        f"version: {same}; valid slots {v.sum(dim=1).tolist()} {'OK' if same else 'FAIL'}")
    if not same:
        raise SystemExit("postprocess_yolo differs between the NMS kernel and its plain version")
    return rows


def conv_flops(torch, model, pixels, text):
    """Multiply-adds x 2 of the detector's convolutions and text products
    for one forward (forward hooks on every conv; the MaxSigmoid and the
    contrastive products from their shapes)."""
    from tstar_tpu_torch.models import yoloworld as yw

    total = [0]

    def conv_hook(mod, inp, out):
        total[0] += 2 * out.numel() * mod.weight.shape[1] * mod.kernel * mod.kernel

    def attn_hook(mod, inp, out):
        b, _, h, w = out.shape
        total[0] += 2 * b * h * w * mod.num_heads * mod.head_c * text.shape[-2]

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules() if isinstance(m, yw.Conv)]
    hooks += [m.register_forward_hook(attn_hook) for m in model.modules()
              if isinstance(m, yw.MaxSigmoidAttnBlock)]
    with torch.no_grad():
        model(pixels, text)
    for h in hooks:
        h.remove()
    # the contrastive head: (anchors x text_dim) . (text_dim x T) an image
    c = model.cfg
    return total[0] + 2 * pixels.shape[0] * c.num_anchors * c.text_dim * text.shape[-2]


def yolo_search(torch, heur, config, seed, graphs=None, decoder=None, record=False):
    """One ``KeyframeSearcher`` over the synthetic 600 s video, every launch
    count set to 0 before the searcher is built (so its prompts' text
    encode is counted).  -> (stamps, searcher, stats, counts, wall s)."""
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.search.engine import run_search as engine_search
    from tstar_tpu_torch.search.searcher import KeyframeSearcher
    from tstar_tpu_torch.search.step_graphs import StepStats
    from tstar_tpu_torch.video.synthetic import default_scene

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    s = KeyframeSearcher("mem://synthetic-600s", heur, YOLO_TARGETS, YOLO_CUES, search_budget=0.5,
                         config=config, seed=seed, decoder=decoder or default_scene(600.0))
    stats = StepStats(record=record)
    with torch.no_grad():
        final, secs = engine_search(s._state0, s.scorer, s.config, graphs, stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s._final_state, s.step_stats = final, stats
    return [float(x) for x in secs.tolist()], s, stats, launch_counts(), wall


def phase_yolo(torch, card, resident):
    """Phase 10b: YOLO-World v2-XL at full width, one video (module
    docstring); its peak memory is counted above ``resident``, the bytes
    earlier phases left allocated.  Returns (heuristic, row of numbers,
    launch counts)."""
    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.tools.profile_search import calibrated_yolo_xl

    t0 = time.perf_counter()
    heur = calibrated_yolo_xl(torch.bfloat16)
    torch.cuda.synchronize()
    n_det = sum(p.numel() for p in heur.model.parameters())
    n_text = sum(p.numel() for p in heur.text_model.parameters())
    log(f"[yolo] YOLO-World v2-XL (widths {heur.model.cfg.widths}, depths "
        f"{heur.model.cfg.depths}, {heur.model.cfg.num_anchors} anchors at 640^2): detector "
        f"{n_det:,} + text tower {n_text:,} parameters, seeded and BN-calibrated in "
        f"{time.perf_counter() - t0:.2f} s")
    if (n_det, n_text) != (72_886_361, 63_396_864):
        raise SystemExit("YOLO-World v2-XL: parameter counts differ from the reference's")
    # the forward alone, B = 1 and 8
    g = torch.Generator(device="cuda").manual_seed(0)
    text = torch.nn.functional.normalize(torch.randn(4, 512, generator=g, device="cuda"), dim=-1)
    fwd = {}
    for b in (1, 8):
        px = torch.rand(b, 640, 640, 3, generator=g, device="cuda").to(torch.bfloat16)
        flops = conv_flops(torch, heur.model, px, text)
        with torch.no_grad():
            ms = cuda_ms(lambda: heur.model(px, text), iters=10)
        b_ms, b_by = bound_ms(n_det * 2 + px.numel() * 2, flops, "bf16")
        fwd[b] = {"ms": ms, "bound_ms": b_ms, "gflop": flops / 1e9}
        log(f"[yolo] XL forward B={b} bf16: {ms:.3f} ms ({ms / b:.3f} ms an image) against a "
            f"bound of {b_ms:.3f} ms ({b_by}: {flops / 1e9:.1f} GFLOP of convolutions and text "
            f"products) ({card})")

    cfg = SearchConfig(cache_hw=(192, 384))
    yolo_search(torch, heur, cfg, seed=1)                              # warm-up
    torch.cuda.reset_peak_memory_stats()
    stamps, s, st, counts, wall = yolo_search(torch, heur, cfg, seed=0, record=True)
    peak = torch.cuda.max_memory_allocated()
    e_stamps, _, e_st, e_counts, e_wall = yolo_search(torch, heur, cfg, seed=0, graphs=False,
                                                      record=True)
    forwards = st.steps + len(st.verify_widths)
    per_video = [e["secs"][0].tolist() for e in st.trace]
    same = stamps == e_stamps and per_video == [e["secs"][0].tolist() for e in e_st.trace]
    n_text_ln = 2 * heur.text_model.text_cfg.num_layers + 1
    want = launches(fused_layernorm=0, greedy_nms=1)
    checks = {
        "graph-stepped == eager (seconds per iteration, keyframes)": same,
        "8 keyframes in range": len(stamps) == 8 and all(0 <= x < 600 for x in stamps),
        "stepped through CUDA graphs": st.replays > 0 and st.host_reads == 2 * st.steps,
        f"K3 {n_text_ln} a search (the prompts' text encode)":
            counts["fused_layernorm"] == n_text_ln == e_counts["fused_layernorm"],
        "NMS once a forward": counts["greedy_nms"] == forwards,
        "no other kernel": all(counts[k] == 0 for k, n in want.items()
                               if k not in ("fused_layernorm", "greedy_nms")),
    }
    log(f"[yolo] search (graphs): iterations {int(s._final_state.iteration)}, {st.steps} grid "
        f"forwards (B=1), verify batches {st.verify_widths}; wall {wall:.3f} s (eager "
        f"{e_wall:.3f} s; both include the scorer's build and prompt encode); peak_mem "
        f"{(peak - resident) / 2**20:.1f} MiB above the {resident / 2**20:.1f} MiB earlier "
        f"phases left allocated; {st.host_reads / st.steps:.2f} host reads, "
        f"{st.replays / st.steps:.2f} graph replays a step ({st.captures} captures) ({card})")
    log(f"[yolo] keyframes {stamps}, remaining {s.remaining_targets}; launches {counts}")
    failed = [k for k, v in checks.items() if not v]
    log(f"[yolo] checks: {sorted(checks)} {'OK' if not failed else 'FAIL ' + str(failed)}")
    if failed:
        raise SystemExit(f"YOLO search checks failed: {failed}")
    # the anchors that clear the score threshold in a grid forward of the search
    px = s.scorer._grid_pixels(s.scorer.cache, torch.arange(16, device="cuda") * 37)
    with torch.no_grad():
        logits, _ = heur.model(px, s.scorer.text_embeds)
        probs = torch.sigmoid(torch.where(s.scorer.query_mask, logits, -1e30)).amax(-1)
    above = int((probs > heur.model.cfg.score_threshold).sum())
    log(f"[yolo] calibrated random weights: {above} of {logits.shape[1]} anchors clear the 0.12 "
        f"threshold in "
        f"a grid forward (probabilities {probs.min().item():.4f} to {probs.max().item():.4f})")
    # device time by kernel line and the busy share: ``python -m
    # tstar_tpu_torch.tools.profile_search --runs yolo`` (torch.profiler
    # imports triton, which this script must not)
    row = {"forward": fwd, "search_wall_s": wall, "eager_wall_s": e_wall,
           "peak_mib": (peak - resident) / 2**20, "grid": st.steps, "verify": st.verify_widths, "anchors_above": above}
    return heur, row, counts


def conv_batch_dependence(torch, model, px, text):
    """-> (how many of the forward's convolutions give image 0 other bits
    inside the batch ``px`` than alone on the same input, how many ran, the
    largest difference of image 0's logits in the batch and alone, and the
    largest logit)."""
    from tstar_tpu_torch.models.yoloworld import Conv

    seen = []
    hooks = [m.register_forward_hook(lambda mod, i, o: seen.append((mod, i[0], o)))
             for m in model.modules() if isinstance(m, Conv)]
    with torch.no_grad():
        batch, _ = model(px, text)
        for h in hooks:
            h.remove()
        parted = sum(not torch.equal(mod(x[:1]), o[:1]) for mod, x, o in seen)
        alone, _ = model(px[:1], text)
    diff = (batch[:1].float() - alone.float()).abs().max().item()
    return parted, len(seen), diff, alone.float().abs().max().item()


def phase_yolo_batched(torch, card, heur):
    """Phase 10c: ``search_videos`` over eight distinct videos in one bucket
    of B = 8 with YOLO-World v2-XL, each video's keyframes held against its
    single-video search in bf16; where they part, the cause shown (the
    convolutions whose bits depend on the batch) and the same comparison in
    f32.  Returns the batched run's launch counts and the dtype held."""
    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.parallel.multi_video import search_videos
    from tstar_tpu_torch.search.engine import run_search as engine_search
    from tstar_tpu_torch.search.state import init_state
    from tstar_tpu_torch.search.step_graphs import StepStats
    from tstar_tpu_torch.tools.profile_search import calibrated_yolo_xl
    from tstar_tpu_torch.video.cache import build_frame_cache

    cfg = SearchConfig(cache_hw=(192, 384), search_budget=0.5)

    def compare(h, label):
        tasks = _batched_tasks()
        search_videos(_batched_tasks(), h, cfg)                         # warm-up
        stats = StepStats(record=True)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        results = search_videos(tasks, h, cfg, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        singles, first = [], []
        for t in tasks:
            cache = build_frame_cache(t.video_path, cfg, device="cuda", decoder=t.decoder)
            scorer = h.build_scorer(cache.frames, t.target_objects, t.cue_objects, cfg)
            with torch.no_grad():       # the first step's grid forward, alone
                first.append(scorer.score_grid(stats.trace[0]["secs"][len(first)])[0])
            state = init_state(cache.n_valid, len(t.target_objects), cfg,
                               torch.Generator(device="cuda").manual_seed(t.seed),
                               n_pad=cache.n_pad, device="cuda")
            final, secs = engine_search(state, scorer, cfg)
            singles.append(([float(x) for x in secs.tolist()], int(final.iteration)))
            del cache, scorer, state, final
            gc.collect()
            torch.cuda.empty_cache()    # the search's graph pool
        same = [r["keyframe_secs"] == sk and r["iterations"] == it
                for r, (sk, it) in zip(results, singles)]
        diff = (stats.trace[0]["conf"].float() - torch.stack(first).float()).abs().max().item()
        forwards = stats.steps + len(stats.verify_widths)
        log(f"[{label}] B=8 x 600 s: {stats.steps} grid forwards of 8, {len(stats.verify_widths)} "
            f"verify forwards of {sorted(set(stats.verify_widths))}; wall {wall:.3f} s; NMS "
            f"{counts['greedy_nms']} launches ({forwards} forwards), K3 {counts['fused_layernorm']}; "
            f"the first grid forward's confidences in the batch against each video's own: max "
            f"|diff| {diff:.3e}; keyframes and iterations equal to each video's single search: "
            f"{same} ({card})")
        return all(same), counts, results, singles

    ok, counts, res, singles = compare(heur, "yolo batched bf16")
    if ok:
        log("[yolo batched] bf16: every video's batched search equals its single search OK")
        return counts, "bf16"
    diff = [(i, r["keyframe_secs"], s[0]) for i, (r, s) in enumerate(zip(res, singles))
            if r["keyframe_secs"] != s[0]]
    g = torch.Generator(device="cuda").manual_seed(5)
    px = torch.rand(8, 640, 640, 3, generator=g, device="cuda").to(torch.bfloat16)
    text = torch.nn.functional.normalize(torch.randn(4, 512, generator=g, device="cuda"), dim=-1)
    parted, n_conv, ldiff, lmax = conv_batch_dependence(torch, heur.model, px, text)
    log(f"[yolo batched] bf16: {len(diff)} of 8 videos' keyframes differ from their single "
        f"searches, e.g. {diff[:2]}; the cause: {parted} of {n_conv} convolutions of the bf16 XL "
        f"forward give image 0 other bits in a batch of 8 than alone on the same input (cuDNN "
        f"picks its algorithm by batch size), and image 0's logits then differ by up to "
        f"{ldiff:.3e} (largest |logit| {lmax:.3e}) ({card})")
    if not parted:
        raise SystemExit("the bf16 batched YOLO search differs from the single searches, "
                         "and the convolutions do not explain it")
    gc.collect()
    torch.cuda.empty_cache()
    h32 = calibrated_yolo_xl(torch.float32)
    ok32, _, _, _ = compare(h32, "yolo batched f32")
    parted32, _, ldiff32, lmax32 = conv_batch_dependence(torch, h32.model, px.float(), text)
    log(f"[yolo batched] f32: {parted32} of {n_conv} convolutions give image 0 other bits in a "
        f"batch of 8, its logits {ldiff32:.3e} apart (largest |logit| {lmax32:.3e}); every "
        f"video's batched search equals its single search: {ok32}")
    del h32
    torch.cuda.empty_cache()
    if not ok32:
        raise SystemExit("batched YOLO search differs from the single-video searches in f32")
    return counts, "f32"


def phase_yolo_numerics(torch, card):
    """Phase 10d: ``yoloworld_small`` bf16 on the card against f32 on the
    CPU; then the small-size YOLO search with replayed noise, f32 on the
    card against the CPU."""
    import numpy as np

    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.framework.heuristics import initialize_heuristic
    from tstar_tpu_torch.search.engine import run_search as engine_search
    from tstar_tpu_torch.search.state import init_state
    from tstar_tpu_torch.video.cache import build_frame_cache_host
    from tstar_tpu_torch.video.synthetic import default_scene

    from tstar_tpu_torch.models.yoloworld import unit_variance_bn_

    cpu = initialize_heuristic("yolo-world-random", size="small", device="cpu",
                               dtype=torch.float32, seed=0)
    rng = np.random.default_rng(0)
    px = rng.random((2, 160, 160, 3), dtype=np.float32)
    text = rng.normal(size=(4, 64)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    card16 = initialize_heuristic("yolo-world-random", size="small", device="cuda",
                                  dtype=torch.bfloat16, seed=0)
    dfl = []
    hooks = [getattr(cpu.model, f"reg_pred{i}_2").register_forward_hook(
        lambda m, i, o: dfl.append(o.abs().max().item())) for i in range(3)]
    with torch.no_grad():
        want_l, want_b = cpu.model(torch.from_numpy(px), torch.from_numpy(text))
        got_l, got_b = card16.model(torch.from_numpy(px).cuda(), torch.from_numpy(text).cuda())
    for h in hooks:
        h.remove()
    got_l, got_b = got_l.float().cpu(), got_b.float().cpu()
    # bf16 keeps 8 bits: 2^-8 of the largest magnitude of a value, compounded
    # over the ~40 conv layers of the path.  A box side moves by at most half
    # the DFL's bin range (reg_max - 1) / 2 times the change of its logits,
    # times the largest stride (32 px).
    tol_l = 2 ** -8 * 40 * want_l.abs().max().item()
    reg_max = cpu.model.cfg.reg_max
    tol_b = 2 ** -8 * 40 * max(dfl) * (reg_max - 1) / 2 * 32
    dl, db = (got_l - want_l).abs().max().item(), (got_b - want_b).abs().max().item()
    # the class is decided wherever the CPU's two best logits are further
    # apart than twice the tolerance: there the card must pick the same one
    top2 = want_l.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * tol_l
    argmax = bool((got_l.argmax(-1) == want_l.argmax(-1))[decided].all())
    ok = dl <= tol_l and db <= tol_b and argmax
    log(f"[yolo numerics] yoloworld_small bf16 on the card vs f32 on the CPU: logits max |diff| "
        f"{dl:.3e} (tol {tol_l:.3e} = 2^-8 x 40 layers x max |logit| {want_l.abs().max().item():.3e}), "
        f"boxes {db:.3e} px (tol {tol_b:.3e} = 2^-8 x 40 layers x max |DFL logit| {max(dfl):.3f} "
        f"x (reg_max - 1) / 2 x 32 px), the same argmax class on all "
        f"{int(decided.sum())} of {decided.numel()} anchors whose top two logits are more than "
        f"2 x tol apart: {argmax} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 10d: yoloworld_small on the card disagrees with the CPU")
    # the whole small search in f32, replayed noise, card against CPU.  Seeded
    # random convs shrink the activations until every score is 0.5 to a few
    # ulps, where any summation order flips the class and NMS ties: the folded
    # BN scales are set, on the CPU, for unit variance on the images above
    # (the scores then lie ~2e-4 apart; an f32 summation order moves them ~1e-6)
    unit_variance_bn_(cpu.model, torch.from_numpy(px), torch.from_numpy(text))
    card32 = initialize_heuristic("yolo-world-random", size="small", device="cuda",
                                  dtype=torch.float32, seed=0)
    card32.model.load_state_dict(cpu.model.state_dict())
    # confidence_threshold 2.0 (the reference bench's worst case): no target is
    # ever confirmed, so every step verifies and the search spends its budget
    cfg = SearchConfig(cache_hw=(48, 96), search_budget=0.5, confidence_threshold=2.0)
    host = build_frame_cache_host("mem://scene", cfg, decoder=default_scene(300.0))
    noise = [rng.gumbel(size=host.n_pad).astype(np.float32) for _ in range(64)]
    out = {}
    for label, h in (("cpu", cpu), ("cuda", card32)):
        dev = h.device
        scorer = h.build_scorer(torch.from_numpy(host.frames).to(dev), YOLO_TARGETS, YOLO_CUES, cfg)
        state = init_state(host.n_valid, 2, cfg, iter(noise), n_pad=host.n_pad, device=dev)
        with torch.no_grad():
            final, secs = engine_search(state, scorer, cfg, graphs=False)
        out[label] = ([float(x) for x in secs.tolist()], int(final.iteration))
    ok = out["cpu"] == out["cuda"]
    log(f"[yolo numerics] yoloworld_small search in f32 with replayed noise: keyframes and "
        f"iterations on the card {out['cuda']} == CPU {out['cpu']}: {ok} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 10d: the small YOLO search on the card differs from the CPU's")


def write_clip_vocab(directory, words=("couch", "lamp", "tv")):
    """A CLIP-style ``vocab.json`` + ``merges.txt`` that spells ``words`` with
    merges, the two special tokens last (EOT the highest id, as CLIP's)."""
    import os

    chars = sorted(set("".join(words)) | set("abcdefghijklmnopqrstuvwxyz"))
    vocab = {}
    for ch in chars:
        vocab.setdefault(ch, len(vocab))
        vocab.setdefault(ch + "</w>", len(vocab))
    merges = []
    for w in words:
        cur = w[0]
        for i, ch in enumerate(w[1:], start=1):
            nxt = ch + "</w>" if i == len(w) - 1 else ch
            merges.append((cur, nxt))
            cur += nxt
            vocab.setdefault(cur, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    with open(os.path.join(directory, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(directory, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")


def phase_checkpoints(torch, card, yolo):
    """Phase 10e: a full-width mmyolo ``.pth`` and an HF OWL-ViT B/32
    directory, written here, loaded through ``initialize_heuristic(...,
    checkpoint_dir=)`` on the card, equal to the models they came from."""
    import os
    import tempfile

    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.framework.heuristics import initialize_heuristic
    from tstar_tpu_torch.models.loader import save_owlvit_checkpoint
    from tstar_tpu_torch.models.yolo_loader import save_yolo_world_checkpoint

    cfg = SearchConfig(cache_hw=(192, 384))
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = save_yolo_world_checkpoint(yolo.model, yolo.text_model, d)
        write_clip_vocab(d)
        loaded = initialize_heuristic("yolo-world", checkpoint_dir=d, size="xl", device="cuda")
        load_s = time.perf_counter() - t0
        g = torch.Generator(device="cuda").manual_seed(3)
        px = torch.rand(2, 640, 640, 3, generator=g, device="cuda")
        ids, mask = loaded.tokenizer.encode_batch(["couch", "lamp", "tv", " "])
        ids, mask = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
        with torch.no_grad():
            te_a, te_b = yolo.text_model(ids, mask), loaded.text_model(ids, mask)
            a, b = yolo.model(px, te_a), loaded.model(px, te_b)
        same = torch.equal(te_a, te_b) and all(torch.equal(x, y) for x, y in zip(a, b))
        stamps = yolo_search(torch, loaded, cfg, seed=0)[0]
        log(f"[checkpoints] YOLO-World v2-XL as an mmyolo .pth ({os.path.getsize(path) / 1e6:.1f} "
            f"MB, {len(torch.load(path, weights_only=True)['state_dict'])} tensors) + CLIP vocab "
            f"files -> initialize_heuristic('yolo-world', checkpoint_dir=...) in {load_s:.2f} s: "
            f"text embeddings, logits and boxes equal to the written model's: {same}; a search "
            f"with the CLIP tokenizer: keyframes {stamps} {'OK' if same else 'FAIL'}")
        if not same:
            raise SystemExit("phase 10e: the loaded YOLO-World checkpoint differs from its model")
    with tempfile.TemporaryDirectory() as d:
        rand = initialize_heuristic("owl-vit-random", device="cuda", dtype=torch.bfloat16, seed=0)
        t0 = time.perf_counter()
        save_owlvit_checkpoint(rand.model, d)
        write_clip_vocab(d)
        owl = initialize_heuristic("owl-vit", checkpoint_dir=d, device="cuda")
        load_s = time.perf_counter() - t0
        rand.tokenizer = owl.tokenizer          # the same prompts' ids on both sides
        runs = [yolo_search(torch, h, cfg, seed=0, record=True) for h in (owl, rand)]
        (sa, _, sta, _, _), (sb, _, stb, _, _) = runs
        per = [[e["secs"][0].tolist() for e in st.trace] for st in (sta, stb)]
        same = sa == sb and per[0] == per[1]
        log(f"[checkpoints] OWL-ViT B/32 as an HF directory (model.safetensors "
            f"{os.path.getsize(os.path.join(d, 'model.safetensors')) / 1e6:.1f} MB, config.json, "
            f"CLIP vocab files) -> initialize_heuristic('owl-vit', checkpoint_dir=...) in "
            f"{load_s:.2f} s: its search equals owl-vit-random's with the same weights and "
            f"tokenizer (seconds of every iteration, keyframes {sa}): {same} "
            f"{'OK' if same else 'FAIL'}")
        if not same:
            raise SystemExit("phase 10e: the OWL-ViT checkpoint's search differs from its weights'")
    del loaded, owl, rand
    torch.cuda.empty_cache()


def phase_10(torch, card):
    """Phase 10: YOLO-World, the NMS kernel and the checkpoints."""
    t0 = time.perf_counter()
    resident = torch.cuda.memory_allocated()     # phase 9a's model, kept for phase 11
    nms_rows = phase_nms(torch, card)
    gc.collect()
    torch.cuda.empty_cache()      # the plain version's (B, N, N) IoU tensors
    yolo, row, counts = phase_yolo(torch, card, resident)
    batched_counts, batched_dtype = phase_yolo_batched(torch, card, yolo)
    phase_yolo_numerics(torch, card)
    phase_checkpoints(torch, card, yolo)
    torch.cuda.empty_cache()
    log(f"[yolo] phase 10 wall {time.perf_counter() - t0:.1f} s ({card})")
    return {"nms": nms_rows, "yolo": row, "counts": counts, "batched_counts": batched_counts,
            "batched_dtype": batched_dtype, "heuristic": yolo}


# ---------------------------------------------------------------------------
# Phase 11: the T* pipeline end to end
# ---------------------------------------------------------------------------

PIPELINE_STAGES = ("grounding", "decode_and_setup", "search", "qa")


class GroundingStandIn:
    """The backend phase 11's grounder talks to.  The grounding request (the
    prompt that asks for key objects) runs through the real backend at full
    width and at the cap the framework asks for, its decode steps, seconds
    and kernel launches recorded; its answer is then replaced by the scene's
    two lines, because seeded weights cannot name the scene's objects.  Every
    other request (the QA stage) goes to the real backend at temperature 0,
    so that its answer can be held against a direct ``inference_qa``."""

    LINES = "couch, lamp\ntv"

    def __init__(self, torch, backend):
        self.torch, self.backend, self.requests = torch, backend, []

    def inference_with_frames(self, query, frames=None, temperature=0.7, max_tokens=128, **kw):
        if "key objects" not in query:
            return self.backend.inference_with_frames(query, frames, 0.0, max_tokens, **kw)
        from tstar_tpu_torch.kernels import launch_counts

        stats = self.backend.stats
        steps0, before = stats.decode_steps, launch_counts()
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        text = self.backend.inference_with_frames(query, frames, temperature, max_tokens, **kw)
        self.torch.cuda.synchronize()
        after = launch_counts()
        self.requests.append({
            "seconds": time.perf_counter() - t0, "max_tokens": max_tokens,
            "decode_steps": stats.decode_steps - steps0,
            "prefill_ms": stats.prefill_ms[-1] if stats.prefill_ms else None,
            "decode_ms": stats.decode_ms[-1] if stats.decode_ms else None,
            "model_text": text[:40], "launches": {k: after[k] - before[k] for k in after},
        })
        return self.LINES


def pipeline_run(torch, card, label, heur, grounder, config, decoder, repeat=2):
    """``TStarFramework.run()`` on the synthetic 600 s video (the phase-5
    search's settings, artifacts off, QA at temperature 0 through the
    stand-in), ``repeat`` times; every launch count set to 0 just before
    each run and read just after it.  -> (framework, its searcher, result,
    launch counts, wall s, peak bytes, bytes allocated as the run began) of
    the last run."""
    import tempfile

    from tstar_tpu_torch.framework.framework import TStarFramework
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts

    with tempfile.TemporaryDirectory() as out:
        for i in range(repeat):
            fw = None                   # the last run's searcher, its cache and graphs
            gc.collect()
            fw = TStarFramework("mem://synthetic-600s", heur, grounder, QA_QUESTION, QA_OPTIONS,
                                search_budget=0.5, config=config, output_dir=out, seed=0,
                                save_artifacts=False, decoder=decoder, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            reset_launch_counts()
            t0 = time.perf_counter()
            result = fw.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            timings = fw.results["Timings"]
            stages = " ".join(f"{k} {timings[k]['total_s']:.4f} s" for k in PIPELINE_STAGES)
            log(f"[{label}] run {i + 1} of {repeat} ({'warm' if i else 'first'}): "
                f"wall {wall:.4f} s = {stages} ({card})")
    return (fw, fw.video_searcher, result, counts, wall, torch.cuda.max_memory_allocated(),
            resident)


def pipeline_checks(torch, card, label, fw, s, result, counts, standin, per_forward, per_run,
                    decoder):
    """The checks 11a and 11b share: the keyframes equal a plain ``search()``
    on the same seed, one history row a search step and two host reads a
    step, each kernel's launches equal to its launches per grid / verify
    forward times the forwards plus ``per_run`` (the prompts' text encode
    and the two VLM requests), K3 54 in the grounding request, and the answer
    equal to a direct ``inference_qa`` at temperature 0 on the keyframes,
    whose request launches K3 54 times and no other kernel."""
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts

    st = s.step_stats
    forwards = (st.steps, len(st.verify_widths))
    objects = result["Grounding Objects"]
    plain = fw.initialize_videoSearcher(objects["target_objects"], objects["cue_objects"])
    visual = fw.initialize_videoSearcher(objects["target_objects"], objects["cue_objects"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, stamps = plain.search()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, v_stamps = visual.search_with_visualization()
    torch.cuda.synchronize()
    visual_wall = time.perf_counter() - t0
    frames = list(decoder.decode_batch([int(t * s.raw_fps) for t in result["Frame Timestamps"]]))
    torch.cuda.synchronize()
    reset_launch_counts()
    qa_steps = standin.backend.stats.decode_steps
    t0 = time.perf_counter()
    answer = fw.grounder.inference_qa(frames, QA_QUESTION, QA_OPTIONS, temperature=0.0)
    torch.cuda.synchronize()
    qa_s = time.perf_counter() - t0
    qa_counts = launch_counts()

    def expected(k):
        n = per_forward.get(k, 0)
        g, v = n if isinstance(n, tuple) else (n, n)
        return g * forwards[0] + v * forwards[1] + per_run.get(k, 0)

    grounding = standin.requests[-1]
    checks = {
        "grounding objects from the stand-in's lines":
            result["Grounding Objects"] == {"target_objects": ["couch", "lamp"],
                                            "cue_objects": ["tv"]},
        "keyframes == a plain search() on the same seed": result["Frame Timestamps"] == stamps,
        "search_with_visualization again == search()": v_stamps == stamps,
        "one history row a step": len(s.P_history) == len(s.sampled_history) == st.steps > 0,
        "two host reads a step, graphs replayed": st.host_reads == 2 * st.steps and st.replays > 0,
        "grounding at the framework's cap (512)": grounding["max_tokens"] == 512,
        "K3 54 in the grounding request": grounding["launches"]["fused_layernorm"] == 54,
        **{f"{k} {per_forward.get(k, 0)} per (grid, verify) forward + {per_run.get(k, 0)} a run":
           counts[k] == expected(k) for k in KERNELS},
        "answer == inference_qa at temperature 0 on the keyframes": result["Answer"] == answer,
        "K3 54 in the QA request, the decode kernels at every step, no other kernel":
            qa_counts["fused_layernorm"] == 54
            and sum(qa_counts[k] for k in KERNELS) == 54
            and decode_launches(qa_counts, standin.backend.stats.decode_steps - qa_steps),
        "8 keyframes in range": len(stamps) == 8 and all(0 <= t < 600 for t in stamps),
    }
    timings = fw.results["Timings"]
    log(f"[{label}] stages (StageTimer, each ended by torch.cuda.synchronize()): "
        + ", ".join(f"{k} {timings[k]['total_s']:.4f} s" for k in PIPELINE_STAGES)
        + f"; grounding request {grounding['seconds']:.4f} s for {grounding['decode_steps']} "
        f"decode steps (cap {grounding['max_tokens']}; prefill {grounding['prefill_ms']} ms, "
        f"decode {grounding['decode_ms']} ms; the seeded model wrote {grounding['model_text']!r}"
        f"...) ({card})")
    log(f"[{label}] search: {st.steps} steps, {forwards[0]} grid + {forwards[1]} verify "
        f"forwards ({st.verify_widths}), {st.host_reads / st.steps:.2f} host reads and "
        f"{st.replays / st.steps:.2f} replays a step, {st.captures} captures; keyframes "
        f"{result['Frame Timestamps']}; search() {plain_wall:.4f} s vs "
        f"search_with_visualization() {visual_wall:.4f} s (fresh searchers, warm); QA request "
        f"{qa_s:.4f} s, answer {answer[:24]!r}; launches in run(): "
        f"{ {k: v for k, v in counts.items() if v} } ({card})")
    failed = [k for k, v in checks.items() if not v]
    log(f"[{label}] checks: {len(checks)} {'OK' if not failed else 'FAIL ' + str(failed)}")
    if failed:
        raise SystemExit(f"{label} checks failed: {failed}")
    return {"stages_s": {k: timings[k]["total_s"] for k in PIPELINE_STAGES},
            "grounding_request_s": grounding["seconds"],
            "grounding_decode_steps": grounding["decode_steps"],
            "grounding_prefill_ms": grounding["prefill_ms"],
            "grounding_decode_ms": grounding["decode_ms"],
            "search_s": plain_wall, "search_with_visualization_s": visual_wall, "qa_s": qa_s,
            "steps": st.steps, "forwards": forwards, "captures": st.captures}


def pipeline_grounder(torch, model, tok):
    """Phase 11's grounder: ``UniversalGrounder`` over ``GroundingStandIn``
    over the 7B-wide LLaVA-OneVision of phase 9a."""
    from tstar_tpu_torch.grounding.universal import UniversalGrounder
    from tstar_tpu_torch.grounding.vlm_backend import TorchVLMBackend
    from tstar_tpu_torch.models.generate import GenerateStats

    backend = TorchVLMBackend.from_model(model, tok)
    backend.stats = GenerateStats(timed=True)
    log("[pipeline] the grounder's backend is a stand-in for the grounding request only: that "
        "request runs on the 7B-wide model at the framework's 512-token cap and is timed, then "
        "its answer is replaced by the scene's two lines ('couch, lamp' / 'tv'), since seeded "
        "weights cannot name the scene's objects; the QA request goes to the model unchanged "
        "but for its temperature, set to 0 (the real parse path: phase 11c and the CPU tests)")
    return UniversalGrounder("llava-onevision-7b", backend=GroundingStandIn(torch, backend))


def pipeline_memory(label, card, peak, resident, weights):
    """Log a run's peak memory: the whole, the bytes allocated as it began
    (``weights``: the VLM's and the heuristic's parameters; the rest what
    earlier runs left, such as the VLM's decode buckets) and the peak above
    them."""
    log(f"[{label}] peak memory {peak / 1e9:.2f} GB = {resident / 1e9:.2f} GB allocated as run() "
        f"began (the VLM's and the heuristic's weights {weights / 1e9:.2f} GB; the rest left by "
        f"earlier runs) + {(peak - resident) / 1e9:.2f} GB above it ({card})")
    return {"peak_gb": peak / 1e9, "resident_gb": resident / 1e9, "weights_gb": weights / 1e9}


def param_bytes(*modules):
    return sum(p.numel() * p.element_size() for m in modules for p in m.parameters())


def pipeline_owl(torch, card, grounder, vlm_bytes):
    """Phase 11a: the pipeline with ``owl-vit-random`` B/32 in bf16 and the
    7B-wide LLaVA-OneVision of phase 9a."""
    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.framework.heuristics import initialize_heuristic
    from tstar_tpu_torch.video.synthetic import default_scene

    heur = initialize_heuristic("owl-vit-random", device="cuda", dtype=torch.bfloat16, seed=0)
    cfg = SearchConfig(cache_hw=(192, 384))
    decoder = default_scene(600.0)
    fw, s, result, counts, wall, peak, resident = pipeline_run(
        torch, card, "pipeline owl", heur, grounder, cfg, decoder)
    text_ln = 2 * heur.model.cfg.text.num_layers + 1
    row = pipeline_checks(
        torch, card, "pipeline owl", fw, s, result, counts, grounder.backend,
        per_forward=dict(fused_mha_from_qkv=12, patch_embed_matmul=1, fused_layernorm=27),
        per_run={"fused_layernorm": text_ln + 2 * 54}, decoder=decoder)
    row.update(wall_s=wall, **pipeline_memory("pipeline owl", card, peak, resident,
                                              vlm_bytes + param_bytes(heur.model)))
    log(f"[pipeline owl] run() wall {wall:.4f} s ({card})")
    return row, counts, heur


def pipeline_yolo(torch, card, yolo, grounder, vlm_bytes):
    """Phase 11b: the pipeline with phase 10's YOLO-World v2-XL
    (``calibrated_yolo_xl``, bf16); the history's boxes are the NMS'd set."""
    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.video.synthetic import default_scene

    cfg = SearchConfig(cache_hw=(192, 384))
    decoder = default_scene(600.0)
    fw, s, result, counts, wall, peak, resident = pipeline_run(
        torch, card, "pipeline yolo", yolo, grounder, cfg, decoder)
    text_ln = 2 * yolo.text_model.text_cfg.num_layers + 1
    row = pipeline_checks(torch, card, "pipeline yolo", fw, s, result, counts, grounder.backend,
                          per_forward={"greedy_nms": 1},
                          per_run={"fused_layernorm": text_ln + 2 * 54}, decoder=decoder)
    with torch.no_grad():
        _, _, dets = s.scorer.score_grid_detailed(
            torch.tensor(s.sampled_history[0], device="cuda"))
    valid = dets["valid"].cpu()
    first = s.detect_bbox_iters[0]
    same = (len(first["boxes"]) == int(valid.sum())
            and first["class_ids"].tolist() == dets["class_ids"].cpu()[valid].tolist()
            and bool(torch.allclose(torch.from_numpy(first["boxes"]).float(),
                                    dets["boxes"].cpu()[valid].float(), atol=1e-2)))
    sizes = [len(d["boxes"]) for d in s.detect_bbox_iters]
    ok = same and len(sizes) == len(s.sampled_history) and max(sizes) <= yolo.model.cfg.max_dets
    log(f"[pipeline yolo] detect_bbox_iters: {sizes} boxes an iteration (at most max_dets "
        f"{yolo.model.cfg.max_dets}); iteration 0's set equal to score_grid_detailed's NMS'd "
        f"(valid) detections on its seconds: {same} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("pipeline yolo: the detection history is not the NMS'd set")
    weights = vlm_bytes + param_bytes(yolo.model, yolo.text_model)
    row.update(wall_s=wall, **pipeline_memory("pipeline yolo", card, peak, resident, weights))
    return row, counts


def pipeline_numerics(torch, card):
    """Phase 11c: a tiny pipeline in f32 (phase 9c's tiny LLaVA-OneVision
    checkpoint through ``UniversalGrounder(model_path=)``, a tiny
    ``owl-vit-random``), on the card and on the CPU, at temperature 0 with
    TF32 off and the search's noise drawn on the CPU and replayed on both
    (the search steps eagerly here; 11a and 11b hold the graph path):
    ``run()``'s grounding objects (or the same parse error), timestamps and
    answer are equal.  Where the tiny model's grounding does not parse, the
    framework's own stages then run with the scene's objects, on both."""
    import tempfile

    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.framework.framework import TStarFramework
    from tstar_tpu_torch.framework.heuristics import initialize_heuristic
    from tstar_tpu_torch.grounding.prompts import GroundingParseError
    from tstar_tpu_torch.grounding.universal import UniversalGrounder
    from tstar_tpu_torch.models import owlvit as tow
    from tstar_tpu_torch.models.loader import save_vlm_checkpoint
    from tstar_tpu_torch.ops.sampling import draw_gumbel
    from tstar_tpu_torch.search import searcher as tsearcher
    from tstar_tpu_torch.video.synthetic import default_scene

    tiny_owl = tow.OwlViTConfig(
        vision=tow.VisionConfig(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                                patch_size=16, image_size=64),
        text=tow.TextConfig(vocab_size=100, hidden_size=24, num_layers=2, num_heads=4,
                            intermediate_size=48, max_length=8),
        projection_dim=24)
    cfg = SearchConfig(cache_hw=(32, 64))
    n_pad = cfg.padded_frames(600)
    g = torch.Generator().manual_seed(7)
    noise = [draw_gumbel(g, n_pad, "cpu").numpy() for _ in range(cfg.iteration_cap(600) + 1)]
    real_init, real_history = tsearcher.init_state, tsearcher.run_search_with_history
    models, special = tiny_vlms(torch)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        save_vlm_checkpoint(models["llava"], d)
        byte_tokenizer(d, special)
        for device in ("cuda", "cpu"):
            grounder = UniversalGrounder("llava-tiny", model_path=d, device=device,
                                         dtype=torch.float32)
            heur = initialize_heuristic("owl-vit-random", device=device, dtype=torch.float32,
                                        model_config=tiny_owl, seed=1)
            fw = TStarFramework("mem://synthetic-600s", heur, grounder, QA_QUESTION, QA_OPTIONS,
                                search_budget=0.5, config=cfg, output_dir=d, seed=0,
                                save_artifacts=False, decoder=default_scene(600.0),
                                device=device)
            replay = lambda *a, **k: real_init(*a, **k).replace(rng=iter(noise))  # noqa: E731
            eager = lambda st, sc, c, graphs=None, stats=None: real_history(  # noqa: E731
                st, sc, c, False, stats)
            qa_at_0 = functools.partial(grounder.inference_qa, temperature=0.0)
            with patched(tsearcher, "init_state", replay), \
                    patched(tsearcher, "run_search_with_history", eager), \
                    patched(grounder, "inference_qa", qa_at_0):
                try:
                    r = fw.run()
                    out[device] = ("run", r["Grounding Objects"], r["Frame Timestamps"],
                                   r["Answer"])
                except GroundingParseError as e:
                    searcher = fw.initialize_videoSearcher(["couch", "lamp"], ["tv"])
                    frames, stamps = fw.perform_search(searcher, visualization=True)
                    out[device] = (f"{type(e).__name__}: {e}", None, stamps,
                                   fw.perform_qa(frames))
    a = out["cuda"]
    ok = a == out["cpu"] and len(a[2]) == 8
    log(f"[pipeline numerics] tiny LLaVA-OneVision checkpoint + tiny owl-vit-random, f32, "
        f"temperature 0, the CPU's noise: grounding {str(a[0] if a[1] is None else a[1])[:70]!r}, "
        f"timestamps {a[2]}, answer {a[3][:24]!r}; cuda == cpu: {a == out['cpu']} "
        f"{'OK' if ok else 'FAIL'} ({card})")
    if not ok:
        raise SystemExit(f"phase 11c: the pipeline on the card differs from the CPU: {out}")


def pipeline_batched(torch, card, heur):
    """Phase 11d: ``search_videos(collect_history=True)`` over phase 8's B = 8
    bucket: the keyframes and iterations of the same bucket without history,
    two host reads a step, each row's history the video's steps."""
    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.parallel.multi_video import search_videos
    from tstar_tpu_torch.search.step_graphs import StepStats

    cfg = SearchConfig(cache_hw=(192, 384), search_budget=0.5)
    runs = {}
    for hist in (False, True):
        search_videos(_batched_tasks(), heur, cfg, collect_history=hist)         # warm-up
        stats = StepStats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = search_videos(_batched_tasks(), heur, cfg, stats=stats, collect_history=hist)
        torch.cuda.synchronize()
        runs[hist] = (res, stats, time.perf_counter() - t0)
    (plain, p_st, p_wall), (hist, h_st, h_wall) = runs[False], runs[True]
    checks = {
        "keyframes and iterations == without history": all(
            h["keyframe_secs"] == p["keyframe_secs"] and h["iterations"] == p["iterations"]
            for p, h in zip(plain, hist)),
        "two host reads a step": h_st.host_reads == 2 * h_st.steps and h_st.replays > 0,
        "one capture per phase, as without history": h_st.captures == p_st.captures,
        "each row's sampled_history: its video's steps": all(
            len(h["sampled_history"]) == len(h["P_history"]) == len(h["detect_bbox_iters"])
            == h["iterations"] for h in hist),
    }
    failed = [k for k, v in checks.items() if not v]
    log(f"[pipeline batched] B=8 x 600 s with collect_history: {h_st.steps} steps, iterations "
        f"{[h['iterations'] for h in hist]}; wall {h_wall:.4f} s vs {p_wall:.4f} s without "
        f"history (decode and upload of the 8 caches included); {h_st.host_reads / h_st.steps:.2f} "
        f"host reads a step, {h_st.captures} captures; checks {len(checks)} "
        f"{'OK' if not failed else 'FAIL ' + str(failed)} ({card})")
    if failed:
        raise SystemExit(f"phase 11d checks failed: {failed}")
    return {"wall_s": h_wall, "plain_wall_s": p_wall, "steps": h_st.steps}


def phase_11(torch, card, vlm_7b_model, yolo):
    """Phase 11: the T* pipeline (module docstring).  Returns the rows and
    the launch counts of 11a's and 11b's runs."""
    t0 = time.perf_counter()
    model, tok = vlm_7b_model
    vlm_bytes = param_bytes(model)
    grounder = pipeline_grounder(torch, model, tok)
    with torch.no_grad():
        yolo_row, yolo_counts = pipeline_yolo(torch, card, yolo, grounder, vlm_bytes)
        del yolo
        gc.collect()
        torch.cuda.empty_cache()
        owl_row, owl_counts, heur = pipeline_owl(torch, card, grounder, vlm_bytes)
    del grounder
    gc.collect()
    torch.cuda.empty_cache()
    pipeline_numerics(torch, card)
    batched_row = pipeline_batched(torch, card, heur)
    log(f"[pipeline] phase 11 wall {time.perf_counter() - t0:.1f} s ({card})")
    return {"rows": {"owl": owl_row, "yolo": yolo_row, "batched": batched_row},
            "counts": {"owl": owl_counts, "yolo": yolo_counts}}

STREAM_TARGETS, STREAM_CUES = ["couch", "lamp"], ["tv"]
# the bf16 B/32 tower's launches per detector forward (phase 5)
TOWER_LAUNCHES = launches(fused_mha_from_qkv=12, patch_embed_matmul=1, fused_layernorm=27)
# what a streaming search may add to its peak memory for each padded second
# of video: its O(n_pad) state (scores, visited, P, noise and their step
# copies, ~60 B), with room; a resident 192x384 cache takes 221,184 B
STREAM_BYTES_PER_SECOND = 256


def stream_searcher(heur, cache_mode, seed, duration=600.0):
    """Phase 5's ``KeyframeSearcher`` (bf16, cache 192x384, budget 0.5) on
    the synthetic scene of ``duration`` seconds, served from memory."""
    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.search.searcher import KeyframeSearcher
    from tstar_tpu_torch.video.synthetic import default_scene

    return KeyframeSearcher(
        f"mem://synthetic-{duration:.0f}s", heur, STREAM_TARGETS, STREAM_CUES, search_budget=0.5,
        config=SearchConfig(cache_hw=(192, 384), cache_mode=cache_mode), seed=seed,
        decoder=default_scene(duration),
    )


def stream_busy_shares(card):
    """The device-busy share of the resident and the streaming search (and
    the streamed 4-hour one), from ``tools/profile_search.py`` in a process
    of its own: ``torch.profiler`` imports triton, which this one must not."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        out = f"{d}/profile.json"
        done = subprocess.run(
            [sys.executable, "-m", "tstar_tpu_torch.tools.profile_search", "--runs", "bf16",
             "bf16 streaming", "bf16 streaming 4h", "--out", out],
            capture_output=True, text=True, timeout=600,
        )
        if done.returncode != 0:
            raise SystemExit(f"profile_search failed ({done.returncode}):\n{done.stderr[-3000:]}")
        with open(out) as f:
            runs = json.load(f)["runs"]
    for label, r in runs.items():
        log(f"[streaming] profiled {label}: wall {r['wall_s']:.4f} s, device {r['device_ms']:.2f} "
            f"ms, busy {100 * r['busy_share']:.1f}% of the profiled wall "
            f"({r['profiled_wall_s']:.4f} s), {r['steps']} steps, "
            f"{r['host_reads_per_step']:.2f} host reads a step, host decode + upload "
            f"{r['stream_ms_per_step']:.3f} ms a step  ({card})")
        for line in r["largest"][:4]:
            log(f"[streaming]   {label}: {line['ms']:.3f} ms {line['count']}x {line['name'][:80]}")
    return {k: r["busy_share"] for k, r in runs.items()}


def phase_12a(torch, card, heur):
    """12a: the 600 s scene searched streaming and resident, both with
    graphs: the same keyframes, iterations and ``P``; the streaming search
    launches phase 5's kernels and reads the host three times a step.
    Returns its launch counts, its peak memory above what it began with and
    its padded seconds."""
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.video.cache import StreamingFrameCache

    runs = {}
    for mode in ("resident", "streaming"):
        stream_searcher(heur, mode, seed=1).search()           # warm-up
        s = stream_searcher(heur, mode, seed=0)
        gc.collect()
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        _, stamps = s.search()
        torch.cuda.synchronize()
        runs[mode] = (s, stamps, time.perf_counter() - t0, launch_counts(),
                      torch.cuda.max_memory_allocated() - start)
    (rs, r_stamps, r_wall, r_counts, _), (ss, s_stamps, s_wall, s_counts, s_above) = (
        runs["resident"], runs["streaming"])
    st = ss.step_stats
    forwards = st.steps + len(st.verify_widths)
    p_diff = (ss._final_state.P.float() - rs._final_state.P.float()).abs().max().item()
    checks = {
        "the streaming search streamed": isinstance(ss.cache, StreamingFrameCache)
        and tuple(ss.cache.frames.shape) == (1, 192, 384, 3),
        "the same keyframes": s_stamps == r_stamps,
        "the same iterations": ss._final_state.iteration == rs._final_state.iteration,
        "P bitwise equal": torch.equal(ss._final_state.P, rs._final_state.P),
        "three host reads a step": st.host_reads == 3 * st.steps,
        "stepped through CUDA graphs": st.replays > 0,
        "the resident search's launches": s_counts == r_counts,
        **{f"{k} launched {n} per forward": s_counts[k] == n * forwards
           for k, n in TOWER_LAUNCHES.items()},
    }
    log(f"[streaming] 12a 600 s: streaming wall {s_wall:.4f} s, resident {r_wall:.4f} s; "
        f"{st.steps} steps, verify batches {st.verify_widths}; {st.host_reads / st.steps:.2f} "
        f"host reads, {st.replays / st.steps:.2f} graph replays a step ({st.captures} captures); "
        f"host decode + upload {1e3 * st.stream_seconds / st.steps:.3f} ms a step; peak "
        f"{s_above / 1e9:.4f} GB above the search's start  ({card})")
    log(f"[streaming] 12a keyframes {s_stamps} (resident {r_stamps}); largest |P| difference "
        f"{p_diff:.3e}; launches {s_counts}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"12a checks failed: {failed}")
    return s_counts, s_above, ss.cache.n_pad


def phase_12b(torch, card, heur, short_above, short_n_pad):
    """12b: the 4-hour scene streamed: its peak memory above the search's
    start at most 12a's 600 s streaming search's (``short_above`` over
    ``short_n_pad`` padded seconds) plus ``STREAM_BYTES_PER_SECOND`` for each
    further padded second, and under 0.5 GB; then ``search_videos`` over
    four videos of which exactly
    one streams, each row equal to that video's single search (resident:
    the streamed row so shows the streaming search equal to the resident
    one on the 4-hour video too)."""
    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.parallel import multi_video
    from tstar_tpu_torch.parallel.multi_video import VideoTask, search_videos
    from tstar_tpu_torch.search.searcher import KeyframeSearcher
    from tstar_tpu_torch.video.cache import StreamingFrameCache
    from tstar_tpu_torch.video.synthetic import default_scene, scene_variant

    stream_searcher(heur, "streaming", seed=1, duration=14400.0).search()   # warm-up
    s = stream_searcher(heur, "streaming", seed=0, duration=14400.0)
    resident_bytes = s.cache.n_pad * 192 * 384 * 3
    gc.collect()
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, stamps = s.search()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    above = torch.cuda.max_memory_allocated() - start
    st = s.step_stats
    allowed = short_above + STREAM_BYTES_PER_SECOND * (s.cache.n_pad - short_n_pad)
    log(f"[streaming] 12b 4 h ({s.cache.n_valid} s, {s.cache.n_pad} padded): wall {wall:.4f} s, "
        f"{st.steps} steps, verify batches {st.verify_widths}, host decode + upload "
        f"{1e3 * st.stream_seconds / st.steps:.3f} ms a step; peak {above / 1e9:.4f} GB above the "
        f"{start / 1e9:.3f} GB the search began with, where a resident cache would take "
        f"{resident_bytes / 1e9:.3f} GB; keyframes {stamps}  ({card})")
    log(f"[streaming] 12b peak above the start: 4 h {above} B, 600 s ({short_n_pad} padded) "
        f"{short_above} B, difference {above - short_above} B (allowed {allowed - short_above} B, "
        f"{STREAM_BYTES_PER_SECOND} B a further padded second)")
    checks = {"the 4-hour video streamed": isinstance(s.cache, StreamingFrameCache),
              "peak above the start at most the 600 s search's plus its O(n_pad) state":
              above <= allowed,
              "peak above the start under 0.5 GB": above < 0.5e9,
              "three host reads a step": st.host_reads == 3 * st.steps}

    cfg = SearchConfig(cache_hw=(192, 384), search_budget=0.5)
    videos = [(14400.0, lambda: default_scene(14400.0)), (600.0, lambda: scene_variant(1, 600.0)),
              (300.0, lambda: scene_variant(2, 300.0)), (450.0, lambda: scene_variant(3, 450.0))]
    tasks = [VideoTask(f"mem://synthetic-{d:.0f}s", STREAM_TARGETS, STREAM_CUES, seed=i,
                       decoder=make()) for i, (d, make) in enumerate(videos)]
    # a 2 GB device total: a bucket of one gets 256 MiB, so the 3.2 GB cache
    # streams and the 600 s one (141.6 MB) stays resident
    streamed = []
    stream_video = multi_video._search_streaming_video
    with patched(multi_video, "_search_streaming_video",
                 lambda task, *a: (streamed.append(task.video_path), stream_video(task, *a))[1]):
        rows = search_videos(tasks, heur, cfg, hbm_budget_bytes=2 * 1024 ** 3)
    checks["exactly the 4-hour video streamed"] = streamed == [tasks[0].video_path]
    for i, ((d, make), row) in enumerate(zip(videos, rows)):
        # the single search keeps every cache resident (the card's whole budget)
        one = KeyframeSearcher(tasks[i].video_path, heur, STREAM_TARGETS, STREAM_CUES,
                               search_budget=0.5, config=cfg, seed=i, decoder=make())
        _, single = one.search()
        same = (row["keyframe_timestamps"] == single
                and row["iterations"] == one._final_state.iteration)
        log(f"[streaming] 12b search_videos {d:.0f} s ({'streamed' if i == 0 else 'resident'}): "
            f"keyframes {row['keyframe_timestamps']}, iterations {row['iterations']}; its single "
            f"resident search {single}, {one._final_state.iteration}: "
            f"{'equal' if same else 'DIFFERENT'}")
        checks[f"{d:.0f} s row equal to its single search"] = same
        del one
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"12b checks failed: {failed}")
    return {"wall_s": wall, "peak_above_gb": above / 1e9, "resident_gb": resident_bytes / 1e9,
            "peak_above_600s_gb": short_above / 1e9}


def phase_12c(torch, card, heur):
    """12c: ``run_search_reference_verify`` on the 600 s scene, its raw frames
    (360x640) resized to 285x600 by ``make_raw_frame_source``: the graphed
    run's decisions and keyframes equal the eager run's."""
    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.search.reference_verify import (
        make_raw_frame_source,
        run_search_reference_verify,
    )
    from tstar_tpu_torch.search.state import init_state
    from tstar_tpu_torch.search.step_graphs import StepStats
    from tstar_tpu_torch.video.cache import build_frame_cache
    from tstar_tpu_torch.video.synthetic import default_scene

    cfg = SearchConfig(cache_hw=(192, 384), search_budget=0.5)
    cache = build_frame_cache("mem://synthetic-600s", cfg, device="cuda",
                              decoder=default_scene(600.0))
    scorer = heur.build_scorer(cache.frames, STREAM_TARGETS, STREAM_CUES, cfg)
    verify_raw, calls = scorer.score_verify_raw, []
    scorer.score_verify_raw = lambda frames: (calls.append(len(frames)), verify_raw(frames))[1]
    source = make_raw_frame_source("mem://synthetic-600s", cfg, decoder=default_scene(600.0))
    runs = {}
    for label, graphs in (("graphs", None), ("eager", False)):
        state = init_state(cache.n_valid, len(STREAM_TARGETS), cfg,
                           torch.Generator(device="cuda").manual_seed(0), n_pad=cache.n_pad,
                           device="cuda")
        stats = StepStats()
        calls.clear()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        final, secs, decisions = run_search_reference_verify(
            state, scorer, cfg, source, collect_decisions=True, graphs=graphs, stats=stats)
        torch.cuda.synchronize()
        runs[label] = (final, secs.cpu().tolist(), decisions, stats, launch_counts(),
                       list(calls), time.perf_counter() - t0)
    (gf, gs, gd, gst, gc_, g_calls, g_wall), (ef, es, ed, est, _, _, e_wall) = (
        runs["graphs"], runs["eager"])
    forwards = gst.steps + len(g_calls)
    log(f"[streaming] 12c reference verify: {len(gd)} decisions "
        f"({sum(d['removed_slot'] is not None for d in gd)} removals) in {gst.steps} steps, "
        f"raw verify batches {g_calls}; keyframes {gs}; wall {g_wall:.4f} s graphed, "
        f"{e_wall:.4f} s eager; launches K1 {gc_['fused_mha_from_qkv']}, K2 "
        f"{gc_['patch_embed_matmul']}, K3 {gc_['fused_layernorm']}  ({card})")
    checks = {
        "graphed decisions equal eager": gd == ed,
        "graphed keyframes equal eager": gs == es,
        "graphed remaining equal eager": torch.equal(gf.remaining, ef.remaining),
        "stepped through CUDA graphs": gst.replays > 0 and est.replays == 0,
        **{f"{k} launched {n} per forward": gc_[k] == n * forwards
           for k, n in TOWER_LAUNCHES.items()},
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"12c checks failed: {failed}")
    return {"decisions": len(gd), "launches": gc_}


def phase_12(torch, card):
    """Phase 12: the streaming search and reference-fidelity verification
    at the full B/32 width in bf16 (module docstring).  Returns 12a's launch
    counts."""
    from tstar_tpu_torch.framework.heuristics import initialize_heuristic

    t0 = time.perf_counter()
    heur = initialize_heuristic("owl-vit-random", device="cuda", dtype=torch.bfloat16, seed=0)
    with torch.no_grad():
        counts, short_above, short_n_pad = phase_12a(torch, card, heur)
        p12b = phase_12b(torch, card, heur, short_above, short_n_pad)
        p12c = phase_12c(torch, card, heur)
    del heur
    gc.collect()
    torch.cuda.empty_cache()
    busy = stream_busy_shares(card)
    log(f"[streaming] phase 12 wall {time.perf_counter() - t0:.1f} s ({card})")
    return {"counts": counts, "long": p12b, "verify": p12c, "busy": busy}


# ---------------------------------------------------------------------------
# Phase 13: the calibrated detector and its A/B tools, Qwen2.5-VL, anyres
# ---------------------------------------------------------------------------

def cal_canvas_scale(torch, heur, cache_hw):
    """The largest per-patch logit scale c_p of ``heur``'s class head on one
    calibration-style grid canvas (16 backgrounds, the couch in half the
    cells): |A_p| of ``_probe_affine``, since img_hat_p is a unit vector."""
    import numpy as np

    from tstar_tpu_torch.framework.heuristics import DEFAULT_COLOR_MAP

    frames = [heur._render_cal_frame(cache_hw, DEFAULT_COLOR_MAP["couch"] if t % 2 else None, t)
              for t in range(16)]
    cache = torch.from_numpy(np.stack(frames)).to(heur.device)
    a, _ = heur._probe_affine(heur._canvas(cache, np.arange(16), (4, 4)))
    return float(np.linalg.norm(a, axis=1).max())


def phase_13a(torch, card):
    """13a: ``initialize_heuristic('owl-vit-calibrated')`` at B/32's full
    width, calibrated in f32 on the card and on the host's CPU (the same
    weights): each direction's cosine >= 0.9999 and each calibration
    statistic within the tolerance derived below; then phase 5's search in
    bf16 with the calibrated scorer.  Returns the search's launch counts."""
    import numpy as np

    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.framework.heuristics import (
        CalibratedOwlVitHeuristic,
        initialize_heuristic,
    )

    cfg = SearchConfig(cache_hw=(192, 384))
    card32 = initialize_heuristic("owl-vit-calibrated", device="cuda", dtype=torch.float32, seed=0)
    cpu32 = CalibratedOwlVitHeuristic(device="cpu", dtype=torch.float32, seed=0)
    cpu32.model.load_state_dict({k: v.cpu() for k, v in card32.model.state_dict().items()})
    seconds = {}
    for label, h in (("cuda", card32), ("cpu", cpu32)):
        t0 = time.perf_counter()
        h.calibrate(cfg.cache_hw, STREAM_TARGETS, STREAM_CUES, cfg)
        if label == "cuda":
            torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
    (dirs_gpu,), (dirs_cpu,) = card32._dir_cache.values(), cpu32._dir_cache.values()
    c_max = cal_canvas_scale(torch, card32, cfg.cache_hw)
    # A statistic is a sigmoid score (slope <= 1/4) of one patch's logit
    # A_p . q + b_p, |A_p| = c_p.  Card and CPU differ in the direction
    # (|dq| moves a logit by at most c_p |dq|) and in the towers' f32
    # summation order (an allowance of 1e-4 of c_p, ten times the 1e-5 the
    # f32 towers agree to relatively in phase 4d's layer and the tests).
    checks, rows = {}, {}
    for name in STREAM_TARGETS + STREAM_CUES:
        qg, qc = dirs_gpu[name].astype(np.float64), dirs_cpu[name].astype(np.float64)
        cos = float(qg @ qc / (np.linalg.norm(qg) * np.linalg.norm(qc)))
        dq = float(np.linalg.norm(qg - qc))
        tol = 0.25 * c_max * (dq + 1e-4)
        diffs = {k: abs(card32.calibration[name][k] - cpu32.calibration[name][k])
                 for k in card32.calibration[name]}
        ok = cos >= 0.9999 and max(diffs.values()) <= tol
        checks[f"{name}: cosine and statistics"] = ok
        rows[name] = {"cosine": cos, "max_stat_diff": max(diffs.values()), "tol": tol,
                      **{f"cuda_{k}": v for k, v in card32.calibration[name].items()}}
        log(f"[calibrated] 13a {name}: direction cosine cuda/cpu {cos:.7f} (want >= 0.9999), "
            f"|dq| {dq:.3e}; statistics max |cuda - cpu| {max(diffs.values()):.3e} (tol 0.25 x "
            f"c_max {c_max:.3f} x (|dq| + 1e-4) = {tol:.3e}); margins grid "
            f"{card32.calibration[name]['grid_margin']:+.4f} verify "
            f"{card32.calibration[name]['verify_margin']:+.4f} (cpu "
            f"{cpu32.calibration[name]['grid_margin']:+.4f} / "
            f"{cpu32.calibration[name]['verify_margin']:+.4f}) {'OK' if ok else 'FAIL'}")
    log(f"[calibrated] 13a f32 calibration of 3 names at B/32 (1,024 probe queries, 28 canvases "
        f"a name): cuda {seconds['cuda']:.2f} s, cpu {seconds['cpu']:.2f} s; suggested detector "
        f"threshold {card32.suggested_detector_threshold:.4f} (cpu "
        f"{cpu32.suggested_detector_threshold:.4f}), confidence "
        f"{card32.suggested_confidence_threshold:.4f} ({cpu32.suggested_confidence_threshold:.4f})"
        f"  ({card})")
    del cpu32, card32
    gc.collect()

    heur = initialize_heuristic("owl-vit-calibrated", device="cuda", dtype=torch.bfloat16, seed=0)
    per_forward = launches(fused_mha_from_qkv=12, patch_embed_matmul=1, fused_layernorm=27)
    counts, _ = run_search(torch, card, heur, "calibrated", cfg, per_forward)
    bf16 = heur.calibration
    log("[calibrated] 13a bf16 calibration margins (grid / verify): " + ", ".join(
        f"{n} {bf16[n]['grid_margin']:+.4f} / {bf16[n]['verify_margin']:+.4f}" for n in bf16)
        + " (random weights at B/32's widths: not required to be positive)")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"13a checks failed: {failed}")
    del heur
    return counts, {"f32": rows, "bf16_margins": {n: (bf16[n]["grid_margin"],
                                                      bf16[n]["verify_margin"]) for n in bf16}}


def run_tool(args, timeout=900):
    """A port tool in a process of its own -> its last stdout line as JSON."""
    done = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          timeout=timeout)
    if done.returncode != 0:
        raise SystemExit(f"{' '.join(args)} failed ({done.returncode}):\n{done.stderr[-3000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def phase_13b(torch, card):
    """13b: ``tools/ab_knob_recall.py --scenes 2 --seeds 2`` (its own
    geometry, f32) in a process of its own: its JSON line and each knob's
    launches (at this geometry K4 does not take the int8 tower's weights,
    K = 64 / 128: the int8 knobs' route plan puts all 12 dense layers in
    plain ops, and no knob launches K4); then the lottery's seed
    calibrated on the card and on the CPU."""
    t0 = time.perf_counter()
    out = run_tool(["tstar_tpu_torch.tools.ab_knob_recall", "--scenes", "2", "--seeds", "2"])
    wall = time.perf_counter() - t0
    log("[knob a/b] " + json.dumps(out))
    knobs = out["knobs"]
    for knob, e in knobs.items():
        log(f"[knob a/b] 13b {knob}: P {e['precision']:.4f} R {e['recall']:.4f} F1 {e['f1']:.4f}, "
            f"mean iterations {e['mean_iterations']}, recall delta vs bf16 "
            f"{e['recall_delta_vs_bf16']:+.4f}, keyframe overlap vs bf16 "
            f"{e.get('keyframe_overlap_vs_bf16', 1.0):.4f}, {e['seconds']:.3f} s, launches "
            f"{e['launches'] or 'none'}, int8 route plan {e.get('int8_routes', '-')}  ({card})")
    checks = {
        "the card's name": out["device"] == torch.cuda.get_device_name(0),
        "six knobs": list(knobs) == ["bf16", "verify128", "verify96", "int8", "w8a16",
                                     "int8_verify128"],
        "a working detector": out["cal_min_margin"] > 0.02,
        "recalls in [0, 1]": all(0.0 <= e["recall"] <= 1.0 for e in knobs.values()),
        "no K4 launch at K = 64": all("w8a8_matmul" not in e["launches"] for e in knobs.values()),
        "the int8 knobs' plan: 12 plain layers": all(
            e.get("int8_routes") == ({"plain": 12} if k.startswith("int8") else None)
            for k, e in knobs.items()),
    }
    log(f"[knob a/b] 13b wall {wall:.1f} s, calibration seed {out['cal_seed']} (min margin "
        f"{out['cal_min_margin']:+.4f})")
    # the lottery's detector calibrated here on the card and on the CPU: the
    # same weights (seeded on the host), so the same directions and margins
    from tstar_tpu_torch.tools.ab_knob_recall import calibrated_heuristic
    from tstar_tpu_torch.utils.config import SearchConfig

    base = SearchConfig(search_budget=1.0)
    cals = {}
    for dev in ("cuda", "cpu"):
        h = calibrated_heuristic(out["cal_seed"], dev)
        cal = h.calibrate(base.cache_hw, ["couch"], [], base)["couch"]
        (dirs,) = h._dir_cache.values()
        cals[dev] = (dirs["couch"].astype("float64"), cal)
    (qg, cg), (qc, cc) = cals["cuda"], cals["cpu"]
    cos = float(qg @ qc / ((qg @ qg) ** 0.5 * (qc @ qc) ** 0.5))
    stat_diff = max(abs(cg[k] - cc[k]) for k in cg)
    margin = min(cg["grid_margin"], cg["verify_margin"])
    checks["the lottery's detector: cuda == cpu"] = cos >= 0.9999 and stat_diff <= 1e-4
    checks["the tool's margin reproduced"] = abs(margin - out["cal_min_margin"]) <= 1e-4
    log(f"[knob a/b] 13b seed {out['cal_seed']} calibrated here: direction cosine cuda/cpu "
        f"{cos:.7f}, statistics max |cuda - cpu| {stat_diff:.3e} (tol 1e-4), min margin "
        f"{margin:+.4f} (cpu {min(cc['grid_margin'], cc['verify_margin']):+.4f})")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"13b checks failed: {failed}")
    return out


def phase_13c(torch, card):
    """13c: ``tools/verify_ab.py --videos 2`` (``owl-vit-random`` B/32, bf16):
    the cache-row verification against the raw 285x600 chain."""
    from tstar_tpu_torch.tools import verify_ab

    t0 = time.perf_counter()
    out = verify_ab.main(["--videos", "2"])
    wall = time.perf_counter() - t0
    log(f"[verify a/b] 13c removal agreement {out['removal_agreement']}, mean keyframe overlap "
        f"{out['mean_keyframe_overlap']}, reference rescores "
        f"{[r['reference_rescores'] for r in out['per_video']]}, wall {wall:.1f} s  ({card})")
    if out["videos"] != 2 or out["device"] != torch.cuda.get_device_name(0):
        raise SystemExit("13c: the verification A/B did not run on the card")
    return out


def tiny_qwen25(torch):
    """13d's tiny Qwen2.5-VL, seeded: windows of 2x2 merge units at 56 px,
    block 1 global; and the special token ids of its byte vocabulary."""
    from tstar_tpu_torch.models.qwen25_vision import Qwen25VisionConfig
    from tstar_tpu_torch.models.qwen2vl import (
        Qwen2VLConfig, Qwen2VLModel, Qwen2VLTextConfig, init_random_,
    )
    from tstar_tpu_torch.models.qwen_tokenizer import SPECIAL_TOKENS

    special = {t: 256 + i for i, t in enumerate(SPECIAL_TOKENS)}
    model = Qwen2VLModel(Qwen2VLConfig(
        vision=Qwen25VisionConfig(depth=2, embed_dim=16, num_heads=2, intermediate_size=32,
                                  hidden_size=32, window_size=56, fullatt_block_indexes=(1,)),
        text=Qwen2VLTextConfig(vocab_size=300, hidden_size=32, num_layers=2, num_heads=4,
                               num_kv_heads=2, intermediate_size=64, rope_theta=10000.0,
                               mrope_section=(1, 1, 2)),
        image_token_id=special["<|image_pad|>"], video_token_id=special["<|video_pad|>"],
        vision_start_token_id=special["<|vision_start|>"]))
    init_random_(model, torch.Generator().manual_seed(3))
    return {"qwen2.5": model}, special


def qwen25_work(model, grid_hw, frames: int, prompt: int, new: int):
    """(vision ops, prefill ops, decode bytes a token) of a Qwen2.5-VL
    request: every product's multiply-adds (x2); a windowed block's
    attention counted within its windows only, causal attention on its
    lower triangle; a decode step reads the language model's weights (one
    embedding row) and the cache so far, once."""
    import numpy as np

    from tstar_tpu_torch.models.qwen25_vision import window_partition

    v, t = model.cfg.vision, model.cfg.text
    p = grid_hw[0] * grid_hw[1]
    rows = frames * p
    d, i = v.embed_dim, v.intermediate_size
    windows = np.bincount(window_partition(*grid_hw, v)[1])
    attn_win, attn_full = 4 * frames * int((windows ** 2).sum()) * d, 4 * frames * p * p * d
    n_full = len(v.fullatt_block_indexes)
    vision = (2 * rows * v.patch_dim * d + v.depth * 2 * rows * (4 * d * d + 3 * d * i)
              + n_full * attn_full + (v.depth - n_full) * attn_win
              + 2 * (rows // 4) * (16 * d * d + 4 * d * v.hidden_size))
    h, kv = t.hidden_size, t.num_kv_heads * t.head_dim
    layer = 2 * prompt * (2 * h * h + 2 * h * kv + 3 * h * t.intermediate_size)
    prefill = vision + t.num_layers * (layer + 2 * prompt * (prompt + 1) * h) + 2 * h * t.vocab_size
    lm = sum(prm.numel() for name, prm in model.named_parameters()
             if not name.startswith(("visual", "embed_tokens")))
    es = model.dtype.itemsize
    return vision, prefill, (lm + h) * es + t.num_layers * 2 * (prompt + new) * kv * es


def phase_13e(torch, card):
    """13e: one QA request at Qwen2.5-VL-7B-Instruct's published widths
    (its config.json: vision depth 32, hidden 1280, 16 heads, intermediate
    3420, window 112, full attention in blocks 7/15/23/31, out 3584; the
    language model Qwen2-7B's), seeded on the card in bf16, byte tokenizer,
    8 frames at the backend's 448^2 pixel cap, 30 new tokens, greedy, through
    ``UniversalGrounder.inference_qa``: the first request captures the
    decode graph, the second is timed.  No detector kernel runs; every decode
    step runs the decode kernels of ``kernels/decode.py`` (28 fused layers)."""
    import tempfile

    from tstar_tpu_torch.grounding.prompts import build_qa_prompt
    from tstar_tpu_torch.grounding.universal import UniversalGrounder
    from tstar_tpu_torch.grounding.vlm_backend import TorchVLMBackend
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.models.generate import GenerateStats
    from tstar_tpu_torch.models.qwen25_vision import Qwen25VisionConfig
    from tstar_tpu_torch.models.qwen2vl import Qwen2VLConfig, Qwen2VLModel, random_model
    from tstar_tpu_torch.models.qwen2vl_processor import prepare_vlm_inputs
    from tstar_tpu_torch.utils.images import load_video_frames
    from tstar_tpu_torch.video.synthetic import default_scene, scene_variant

    cfg = Qwen2VLConfig(vision=Qwen25VisionConfig(intermediate_size=3420))
    t0 = time.perf_counter()
    model = random_model(Qwen2VLModel, cfg, torch.bfloat16, "cuda", seed=0)
    torch.cuda.synchronize()
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    v, t = cfg.vision, cfg.text
    log(f"[qwen2.5] Qwen2.5-VL at 7B widths (vision {v.embed_dim} x {v.depth}, intermediate "
        f"{v.intermediate_size}, window {v.window_size}, full attention "
        f"{v.fullatt_block_indexes}; Qwen2 {t.hidden_size} x {t.num_layers}, vocab "
        f"{t.vocab_size}): "
        f"{n_params / 1e9:.3f} B parameters, {n_params * 2 / 1e9:.2f} GB bf16, seeded on the card "
        f"in {time.perf_counter() - t0:.2f} s ({card})")
    with tempfile.TemporaryDirectory() as tmp:
        tok = byte_tokenizer(tmp)
    backend = TorchVLMBackend.from_model(model, tok)
    grounder = UniversalGrounder("qwen2.5-vl-7b", backend=backend)
    frames = load_video_frames("mem://scene", 8, decoder=default_scene(600.0))
    first = grounder.inference_qa(frames, QA_QUESTION, QA_OPTIONS, temperature=0.0)
    frames2 = load_video_frames("mem://scene", 8, decoder=scene_variant(3))
    backend.stats = GenerateStats(timed=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    answer = grounder.inference_qa(frames2, QA_QUESTION, QA_OPTIONS, temperature=0.0)
    torch.cuda.synchronize()
    request_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    st = backend.stats
    inp = prepare_vlm_inputs(tok, build_qa_prompt(QA_QUESTION, QA_OPTIONS, 8), frames2, cfg.vision,
                             max_pixels=backend.max_pixels, image_token_id=cfg.image_token_id)
    s, grid = int(inp["prompt_lens"][0]), tuple(inp["image_grid_hw"])
    vision_ops, prefill_ops, step_bytes = qwen25_work(model, grid, 8, s, 30)
    prefill_ms, decode_ms, steps = st.prefill_ms[-1], st.decode_ms[-1], st.decode_steps
    b_prefill = prefill_ops / PEAK_OPS_PER_S["bf16"] * 1e3
    b_step = step_bytes / HBM_BYTES_PER_S * 1e3
    per_token = decode_ms / max(steps, 1)
    ok = (isinstance(answer, str) and isinstance(first, str) and st.captures == 0
          and st.replays >= 1 and not any(counts[k] for k in KERNELS)
          and decode_launches(counts, steps))
    log(f"[qwen2.5] 13e QA request, 8 frames at grid {grid} patches ({grid[0] * grid[1] // 4} "
        f"tokens a frame), prompt {s} tokens, answer {answer[:24]!r}: prefill {prefill_ms:.3f} ms "
        f"(bound {b_prefill:.3f} ms: {prefill_ops / 1e12:.3f} TFLOP, vision "
        f"{vision_ops / 1e12:.3f}), decode {decode_ms:.3f} ms for {steps} steps = "
        f"{per_token:.3f} ms a token (bound {b_step:.3f} ms: {step_bytes / 1e9:.2f} GB a token), "
        f"request {request_s:.4f} s, captures {st.captures} (the first request captured), "
        f"replays {st.replays}; peak memory {peak / 1e9:.2f} GB (weights "
        f"{n_params * 2 / 1e9:.2f} GB); port kernel launches {counts} "
        f"{'OK' if ok else 'FAIL'}  ({card})")
    if not ok:
        raise SystemExit("13e: the Qwen2.5-VL request failed its checks")
    del grounder, backend, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"prefill_ms": prefill_ms, "prefill_bound_ms": b_prefill,
            "decode_ms_per_token": per_token, "decode_bound_ms_per_token": b_step,
            "request_s": request_s, "peak_gb": peak / 1e9, "prompt_tokens": s,
            "params_b": n_params / 1e9}


def phase_13f(torch, card):
    """13f: ``encode_anyres_image`` at phase 9a's SigLIP widths (so400m/384,
    1152 x 27, projector into 3584) on a 1080x1120 image that takes the
    1152^2 pinpoint (3x3 tiles + the base, rows unpadded): bf16 with K3
    against the f32 run with K3's plain version on the card.  The language
    model is not on this path: one layer of it is built."""
    import numpy as np

    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.kernels.layernorm import fused_layernorm_plain
    from tstar_tpu_torch.models import transformer
    from tstar_tpu_torch.models.llava_onevision import (
        LlavaOnevisionConfig, LlavaOnevisionModel, preprocess_anyres_image,
    )
    from tstar_tpu_torch.models.qwen2vl import random_model
    from tstar_tpu_torch.video.synthetic import default_scene, render_frame

    cfg = LlavaOnevisionConfig()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_layers=1))
    pinpoints = [[384 * i, 384 * j] for i in range(1, 7) for j in range(1, 7)]
    image = render_frame(75.0, (1080, 1120), default_scene(600.0).objects)
    t0 = time.perf_counter()
    tiles, size, grid = preprocess_anyres_image(image, cfg, pinpoints)
    host_s = time.perf_counter() - t0
    model = random_model(LlavaOnevisionModel, cfg, torch.float32, "cuda", seed=2)
    px = torch.from_numpy(tiles).to("cuda")
    with patched(transformer, "fused_layernorm", fused_layernorm_plain):
        reset_launch_counts()
        want = model.encode_anyres_image(px, size, grid).float()
        torch.cuda.synchronize()
        plain_counts = launch_counts()
    model = model.to(torch.bfloat16)
    reset_launch_counts()
    got = model.encode_anyres_image(px.to(torch.bfloat16), size, grid).float()
    torch.cuda.synchronize()
    counts = launch_counts()
    ms = cuda_ms(lambda: model.encode_anyres_image(px.to(torch.bfloat16), size, grid), iters=5,
                 warmup=1)
    rel = ((got - want).norm() / want.norm()).item()
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    side = cfg.vision.image_size // cfg.vision.patch_size
    # bf16 keeps 8 significant bits (unit roundoff 2^-9).  From the pixels
    # to the features a value is rounded at ~170 points in series (the patch
    # embedding, 6 in each of the 27 layers, the projector's two); in
    # quadrature that is ~sqrt(170) x 2^-9 ~ 2.5e-2 of the signal: the
    # relative L2 error is held to twice that, 5e-2
    tol = 5e-2
    others = {k: v for k, v in counts.items() if k != "fused_layernorm" and v}
    ok = (got.shape == want.shape and bool(got.isfinite().all()) and rel <= tol
          and grid == (3, 3) and counts["fused_layernorm"] == 2 * cfg.vision.num_layers
          and not others and not any(plain_counts.values()))
    log(f"[anyres] 13f image {size} -> pinpoint grid {grid} ({len(tiles)} tiles of "
        f"{cfg.vision.image_size}^2, host preprocess {host_s:.3f} s): {got.shape[0]} tokens "
        f"({side * side} base + the unpadded grid with a newline a row); bf16 (K3) vs f32 (plain) "
        f"relative L2 {rel:.3e} (tol {tol:.0e}), max |diff| {diff:.3e} of max |ref| {scale:.3e}; "
        f"K3 launches {counts['fused_layernorm']} (want {2 * cfg.vision.num_layers}: two a "
        f"layer), other kernels {others or 'none'}, plain run {sum(plain_counts.values())}; "
        f"encode {ms:.3f} ms (bf16) {'OK' if ok else 'FAIL'}  ({card})")
    if not ok:
        raise SystemExit("13f: the anyres path on the card failed its checks")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": counts, "rel_l2": rel, "ms": ms, "tokens": got.shape[0]}


def phase_13(torch, card):
    """Phase 13 (module docstring).  Returns 13a's and 13f's launch counts and
    each sub-phase's numbers."""
    t0 = time.perf_counter()
    with torch.no_grad():
        cal_counts, cal = phase_13a(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        knob_ab = phase_13b(torch, card)
        verify = phase_13c(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        models, special = tiny_qwen25(torch)
        vlm_facade(torch, card, models, special)
        qa = phase_13e(torch, card)
        anyres = phase_13f(torch, card)
    log(f"[phase 13] wall {time.perf_counter() - t0:.1f} s ({card})")
    return {"counts": cal_counts, "calibration": cal, "knob_ab": knob_ab, "verify": verify,
            "qwen25": qa, "anyres": anyres}


# ---------------------------------------------------------------------------
# Phase 14: the multi-device layer
# ---------------------------------------------------------------------------

TP_LM_LAYERS = 4      # phase 14d cuts LLaVA-OneVision's 28 decoder layers to this


def _rows_key(rows):
    return [(r["keyframe_secs"], r["iterations"]) for r in rows]


def _search(torch, heur, cfg, tasks, record=False, **kw):
    """``search_videos`` with fresh stats (``record``: each step's trace)
    and launch counts -> (rows, stats, counts, wall)."""
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.parallel import search_videos
    from tstar_tpu_torch.search.step_graphs import StepStats

    stats = StepStats(record=record)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    rows = search_videos(tasks, heur, cfg, stats=stats, **kw)
    torch.cuda.synchronize()
    return rows, stats, launch_counts(), time.perf_counter() - t0


def phase_14a(torch, card):
    """Phase 14a: a one-rank NCCL mesh.  Phase 8's bucket of 8 (B/32, bf16)
    through ``search_videos`` without a mesh, with ``mesh=make_mesh(1, 1)``,
    and with the detector ``shard_module``d at model = 1 (every row-parallel
    layer all-reduces over the one-rank NCCL group, inside the captured
    graphs): the same keyframes, iterations, graph replays and host reads a
    step.  Returns the sharded run's launch counts and the unsharded rows."""
    import torch.distributed as dist

    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.framework.heuristics import initialize_heuristic
    from tstar_tpu_torch.parallel import make_mesh, shard_module

    cfg = SearchConfig(cache_hw=(192, 384), search_budget=0.5)
    heur = initialize_heuristic("owl-vit-random", device="cuda", dtype=torch.bfloat16, seed=0)
    mesh = make_mesh(1, 1)
    try:
        runs = {"no mesh": _search(torch, heur, cfg, _batched_tasks()),
                "mesh 1x1": _search(torch, heur, cfg, _batched_tasks(), mesh=mesh)}
        shard_module(heur.model, mesh)
        runs["shard_module 1x1"] = _search(torch, heur, cfg, _batched_tasks(), mesh=mesh)
        base_rows, base, base_counts, _ = runs["no mesh"]
        for label, (rows, stats, counts, wall) in runs.items():
            ok = (_rows_key(rows) == _rows_key(base_rows) and stats.replays > 0
                  and stats.replays * base.steps == base.replays * stats.steps
                  and stats.host_reads == 2 * stats.steps and not stats.eager_reason
                  and counts == base_counts)
            log(f"[mesh 1x1] {label} ({mesh.backend}): {stats.steps} steps, iterations "
                f"{[r['iterations'] for r in rows]}, keyframes and iterations equal to the "
                f"unmeshed search: {_rows_key(rows) == _rows_key(base_rows)}; "
                f"{stats.replays / stats.steps:.2f} graph replays and "
                f"{stats.host_reads / stats.steps:.2f} host reads a step ({stats.captures} "
                f"captures), launches {counts == base_counts and 'equal' or counts}; "
                f"wall {wall:.3f} s ({card}) {'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"phase 14a: {label} differs from the search without a mesh")
        row_parallel = sum(1 for m in heur.model.modules() if getattr(m, "reduce", None))
        log(f"[mesh 1x1] the sharded detector holds {row_parallel} row-parallel layers, each "
            "all-reducing over the one-rank NCCL group inside the step graphs")
        return runs["shard_module 1x1"][2], base_rows
    finally:
        dist.destroy_process_group()


def llava_tp_config():
    """Phase 9a's LLaVA-OneVision at 7B widths, the LM cut to TP_LM_LAYERS."""
    from tstar_tpu_torch.models.llava_onevision import LlavaOnevisionConfig

    cfg = LlavaOnevisionConfig()
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_layers=TP_LM_LAYERS))


def llava_runs(torch, dev, mesh=None):
    """Phase 9a's QA request (8 frames of the 600 s scene) through the cut
    LLaVA-OneVision, whole or sharded over ``mesh``: greedy tokens in f32,
    the prefill's next-token logits in bf16, a sampled request (temperature
    0.7, generator seed 5) in bf16; the decode's ms a token and the peak
    memory."""
    import tempfile

    from tstar_tpu_torch.grounding.prompts import build_qa_prompt
    from tstar_tpu_torch.models.generate import GenerateStats, bucket_len, generate, prefill
    from tstar_tpu_torch.models.llava_onevision import LlavaOnevisionModel, prepare_llava_inputs
    from tstar_tpu_torch.models.qwen2vl import random_model
    from tstar_tpu_torch.parallel import shard_module
    from tstar_tpu_torch.utils.images import load_video_frames
    from tstar_tpu_torch.video.synthetic import default_scene

    cfg = llava_tp_config()
    with tempfile.TemporaryDirectory() as tmp:
        tok = byte_tokenizer(tmp)
    frames = load_video_frames("mem://scene", 8, decoder=default_scene(600.0))
    inp = prepare_llava_inputs(tok, build_qa_prompt(QA_QUESTION, QA_OPTIONS, 8), frames, cfg)
    eos = [tok.eos_id, tok.pad_id]
    args = (inp["input_ids"], inp["prompt_lens"], inp["position_ids"])
    out = {"prompt_tokens": int(inp["prompt_lens"][0])}
    torch.cuda.reset_peak_memory_stats(dev)

    def model(dtype):
        m = random_model(LlavaOnevisionModel, cfg, dtype, dev, seed=0)
        return shard_module(m, mesh) if mesh is not None else m

    m = model(torch.float32)
    stats = GenerateStats(timed=True)
    out["greedy"] = generate(m, *args, max_new_tokens=30, eos_token_ids=eos, temperature=0.0,
                             image_patches=inp["image_patches"], stats=stats).tolist()
    out["eager_reason"] = stats.eager_reason
    out["fused_layers"] = [fused_layers(stats)]
    del m
    torch.cuda.empty_cache()
    m = model(torch.bfloat16)
    d = to_device(torch, inp, dev)
    s = d["input_ids"].shape[1]
    out["logits"], _ = prefill(m, d["input_ids"], d["prompt_lens"], d["position_ids"],
                               d["image_patches"], None, bucket_len(s + 1))
    out["logits"] = out["logits"].float().cpu()
    stats = GenerateStats(timed=True)
    gen = torch.Generator(device=dev).manual_seed(5)
    out["sampled"] = generate(m, *args, max_new_tokens=30, eos_token_ids=eos, temperature=0.7,
                              generator=gen, image_patches=inp["image_patches"],
                              stats=stats).tolist()
    out["prefill_ms"] = stats.prefill_ms[-1]
    out["decode_ms_per_token"] = stats.decode_ms[-1] / max(1, stats.decode_steps)
    out["captures"] = stats.captures
    out["fused_layers"].append(fused_layers(stats))     # f32: none; bf16: every layer
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["params"] = sum(p.numel() for p in m.parameters())
    del m
    torch.cuda.empty_cache()
    return out


def phase14_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One of phase 14's two ranks on cuda:0 over gloo: (b) data = 2, (c)
    model = 2 on B/32, (d) model = 2 on the cut LLaVA-OneVision."""
    import os
    import pickle

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        out = _phase14_rank_body(torch)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _phase14_rank_body(torch):
    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.framework.heuristics import initialize_heuristic
    from tstar_tpu_torch.kernels import attention, launch_counts, reset_launch_counts
    from tstar_tpu_torch.models.owlvit import (
        OwlViTDetector, init_params, owlvit_base_patch32, postprocess_detections,
    )
    from tstar_tpu_torch.parallel import make_mesh, shard_module

    dev = torch.device("cuda", 0)
    cfg = SearchConfig(cache_hw=(192, 384), search_budget=0.5)
    out = {}

    # (b) data = 2: each rank searches 4 of the 8 videos, f32 and bf16
    dp = make_mesh(data=2, model=1, backend="gloo", device=dev)
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        heur = initialize_heuristic("owl-vit-random", device=dev, dtype=dtype, seed=0)
        rows, stats, _, wall = _search(torch, heur, cfg, _batched_tasks(), mesh=dp)
        out[f"dp_{name}"] = {"rows": rows, "steps": stats.steps, "replays": stats.replays,
                             "host_reads": stats.host_reads, "eager": stats.eager_reason,
                             "wall": wall}
        del heur

    # (c) model = 2: B/32's forward at 6 heads a rank, then TP searches
    tp = make_mesh(data=1, model=2, backend="gloo", device=dev)
    whole = init_params(OwlViTDetector(owlvit_base_patch32()), 0).to(dev, torch.bfloat16)
    sharded = init_params(OwlViTDetector(owlvit_base_patch32()), 0).to(dev, torch.bfloat16)
    shard_module(sharded, tp)
    g = torch.Generator(device=dev).manual_seed(4)
    px = torch.randn(1, 768, 768, 3, generator=g, device=dev).to(torch.bfloat16)
    q = torch.nn.functional.normalize(
        torch.randn(3, whole.cfg.text.hidden_size, generator=g, device=dev), dim=-1)
    with torch.no_grad():
        want = postprocess_detections(*whole.predict(whole.encode_image(px), q.to(torch.bfloat16)),
                                      (768, 768))
        reset_launch_counts()
        got = postprocess_detections(*sharded.predict(sharded.encode_image(px),
                                                      q.to(torch.bfloat16)), (768, 768))
        k1 = attention.fused_mha_from_qkv.launches
    attn = sharded.vision.encoder.layers[0].self_attn
    out["forward"] = {"score_err": (got[0].float() - want[0].float()).abs().max().item(),
                      "box_err": (got[2].float() - want[2].float()).abs().max().item(),
                      "agree": (got[1] == want[1]).float().mean().item(),
                      "finite": bool(torch.isfinite(got[0]).all()), "k1": k1,
                      "heads": attn.num_heads, "qkv_width": attn.qkv_kernel.shape[1]}
    del whole, sharded
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        heur = initialize_heuristic("owl-vit-random", device=dev, dtype=dtype, seed=0)
        shard_module(heur.model, tp)
        rows, stats, counts, wall = _search(torch, heur, cfg, _batched_tasks(2), mesh=tp)
        out[f"tp_{name}"] = {"rows": rows, "steps": stats.steps, "replays": stats.replays,
                             "verify": len(stats.verify_widths), "eager": stats.eager_reason,
                             "counts": counts, "wall": wall, "host_reads": stats.host_reads}
        del heur
    out["tp_grid"] = tp_grid_difference(torch, tp, dev)
    torch.cuda.empty_cache()

    # (d) model = 2: the cut LLaVA-OneVision at 7B widths
    out["llava"] = llava_runs(torch, dev, tp)
    return out


def phase_14_references(torch, card):
    """The one-process runs phase 14b-d compare with: the f32 bucket of 8 and
    the f32 and bf16 buckets of 2 (B/32), and the cut LLaVA-OneVision's
    request."""
    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.framework.heuristics import initialize_heuristic

    cfg = SearchConfig(cache_hw=(192, 384), search_budget=0.5)
    refs = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        heur = initialize_heuristic("owl-vit-random", device="cuda", dtype=dtype, seed=0)
        if name == "f32":
            refs["b8_f32"] = _search(torch, heur, cfg, _batched_tasks())[0]
        rows, stats, counts, wall = _search(torch, heur, cfg, _batched_tasks(2))
        refs[f"b2_{name}"] = {"rows": rows, "wall": wall, "steps": stats.steps}
        del heur
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    refs["llava"] = llava_runs(torch, torch.device("cuda", 0))
    log(f"[tp refs] one-process LLaVA-OneVision (7B widths, LM cut to {TP_LM_LAYERS} of 28 "
        f"layers, {refs['llava']['params'] / 1e9:.3f} B parameters): prompt "
        f"{refs['llava']['prompt_tokens']} tokens, bf16 decode "
        f"{refs['llava']['decode_ms_per_token']:.3f} ms a token (graphs), peak "
        f"{refs['llava']['peak_gb']:.2f} GB, {time.perf_counter() - t0:.1f} s ({card})")
    gc.collect()
    torch.cuda.empty_cache()
    return refs


def batch_dependence(torch, n=8):
    """Why a bf16 bucket of 4 may part from the bucket of 8: the first grid
    forward of videos 0-3 in each, the largest confidence difference in
    bf16 and in f32 (TF32 off)."""
    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.framework.heuristics import initialize_heuristic
    from tstar_tpu_torch.ops.sampling import uniform_stride_indices
    from tstar_tpu_torch.parallel.batched import stack_scorers
    from tstar_tpu_torch.video.cache import build_frame_cache

    cfg = SearchConfig(cache_hw=(192, 384), search_budget=0.5)
    tasks = _batched_tasks(n)
    out = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        heur = initialize_heuristic("owl-vit-random", device="cuda", dtype=dtype, seed=0)
        caches = [build_frame_cache(t.video_path, cfg, device="cuda", decoder=t.decoder)
                  for t in tasks]
        scorers = [heur.build_scorer(c.frames, t.target_objects, t.cue_objects, cfg)
                   for c, t in zip(caches, tasks)]
        secs = uniform_stride_indices(caches[0].n_valid, 16, device="cuda")[None].expand(n, -1)
        with torch.no_grad():
            full = stack_scorers(scorers, cfg).score_grid_batch(secs)[0].float()
            half = stack_scorers(scorers[:n // 2], cfg).score_grid_batch(secs[:n // 2])[0].float()
        out[name] = (full[:n // 2] - half).abs().max().item()
        del heur, caches, scorers
    torch.cuda.empty_cache()
    return out


def tp_grid_difference(torch, mesh, dev, n=2, cfg=None, dtypes=("bf16", "f32")):
    """Why a bf16 TP search may part from one rank's: the first grid forward
    of the bucket of ``n`` through the detector sharded over ``mesh``
    against the whole detector on this rank, the largest confidence
    difference in bf16 and in f32 (TF32 off), or in ``dtypes``; ``cfg``
    (phase 5's cache by default) may set the detector's knobs."""
    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.framework.heuristics import initialize_heuristic
    from tstar_tpu_torch.ops.sampling import uniform_stride_indices
    from tstar_tpu_torch.parallel import shard_module
    from tstar_tpu_torch.parallel.batched import stack_scorers
    from tstar_tpu_torch.video.cache import build_frame_cache

    cfg = cfg or SearchConfig(cache_hw=(192, 384), search_budget=0.5)
    tasks = _batched_tasks(n)
    caches = [build_frame_cache(t.video_path, cfg, device=dev, decoder=t.decoder) for t in tasks]
    secs = uniform_stride_indices(caches[0].n_valid, 16, device=dev)[None].expand(n, -1)
    out = {}
    for name in dtypes:
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[name]
        confs = []
        for sharded in (False, True):
            heur = initialize_heuristic("owl-vit-random", device=dev, dtype=dtype, seed=0)
            if sharded:
                shard_module(heur.model, mesh)
            scorers = [heur.build_scorer(c.frames, t.target_objects, t.cue_objects, cfg)
                       for c, t in zip(caches, tasks)]
            with torch.no_grad():
                confs.append(stack_scorers(scorers, cfg).score_grid_batch(secs)[0].float())
            del heur, scorers
        out[name] = (confs[0] - confs[1]).abs().max().item()
    del caches
    torch.cuda.empty_cache()
    return out


def phase_14(torch, card):
    """Phase 14: the multi-device layer (module docstring).  Returns the
    launch counts of 14a's sharded search and of 14c's bf16 TP search."""
    import os
    import socket
    import tempfile

    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    counts_1x1, base_rows = phase_14a(torch, card)
    refs = phase_14_references(torch, card)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(phase14_rank, args=(2, port, out_dir), nprocs=2,
                           start_method="spawn")
        import pickle

        outs = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
    spawn_s = time.perf_counter() - t0
    failed = []

    # (b) data = 2 over gloo: f32 equal to the one-process bucket of 8
    for r, out in enumerate(outs):
        dp = out["dp_f32"]
        ok = (_rows_key(dp["rows"]) == _rows_key(refs["b8_f32"]) and dp["replays"] > 0
              and not dp["eager"] and dp["host_reads"] == 2 * dp["steps"])
        log(f"[mesh 2x1 gloo] rank {r}: 4 of the 8 videos a rank in f32 (TF32 off), every row "
            f"back on every rank: keyframes and iterations equal to the one-process bucket of "
            f"8: {_rows_key(dp['rows']) == _rows_key(refs['b8_f32'])}; {dp['steps']} steps, "
            f"{dp['replays'] / dp['steps']:.2f} graph replays a step (no collective in a step: "
            f"graphs kept); wall {dp['wall']:.3f} s ({card}) {'OK' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"14b rank {r}")
    bf = outs[0]["dp_bf16"]["rows"]
    same = sum(a == b for a, b in zip(_rows_key(bf), _rows_key(base_rows)))
    dep = batch_dependence(torch)
    log(f"[mesh 2x1 gloo] bf16: {same} of 8 videos' keyframes and iterations equal to phase "
        f"8's bucket of 8 (phase 14a's unmeshed run); the cause of a difference: the first grid "
        f"forward of videos 0-3 in a bucket of 4 against the same videos in the bucket of 8 "
        f"differs by {dep['bf16']:.3e} in bf16 and {dep['f32']:.3e} in f32 (the GEMMs' "
        f"algorithms depend on the batch; phase 10c's finding for cuDNN)")

    # (c) model = 2 over gloo: B/32's forward at 6 heads a rank, TP searches
    for r, out in enumerate(outs):
        f = out["forward"]
        ok = (f["score_err"] <= 2e-2 and f["finite"] and f["k1"] == 12 and f["heads"] == 6
              and f["qkv_width"] == 3 * 384)
        log(f"[mesh 1x2 gloo] rank {r}: B/32 grid forward at full width, bf16, 6 heads a rank "
            f"(q|k|v 3 x 384): max |score TP - one rank| {f['score_err']:.3e} (tol 2e-2, phase "
            f"4's), boxes {f['box_err']:.3e} px, class agreement {f['agree']:.4f}; K1 launched "
            f"{f['k1']} times (want 12) {'OK' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"14c forward rank {r}")
        for name in ("f32", "bf16"):
            t = out[f"tp_{name}"]
            ref = refs[f"b2_{name}"]
            equal = _rows_key(t["rows"]) == _rows_key(ref["rows"])
            forwards = t["steps"] + t["verify"]
            per_scorer = 2 * 12 + 1         # the prompts' text encode: K3, no K1
            k = t["counts"]
            launched = (k["fused_mha_from_qkv"] == 12 * forwards
                        and k["fused_layernorm"] == 27 * forwards + 2 * per_scorer)
            ok = (equal or name == "bf16") and t["eager"] and t["replays"] == 0 and launched
            why = "" if equal or name == "f32" else " (bf16; the cause below)"
            log(f"[mesh 1x2 gloo] rank {r}: {name} TP search of 2 videos: keyframes and "
                f"iterations equal to one rank's: {equal}{why}; {t['steps']} steps, {forwards} "
                f"forwards, eager steps (graphs: none; {t['eager']}); K1 "
                f"{k['fused_mha_from_qkv']} (12 a forward), K3 {k['fused_layernorm']}; wall "
                f"{t['wall']:.3f} s against one rank's {ref['wall']:.3f} s with graphs "
                f"({card}) {'OK' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"14c {name} search rank {r}")
        g = out["tp_grid"]
        ok = g["f32"] <= 1e-4
        log(f"[mesh 1x2 gloo] rank {r}: the cause of a bf16 difference: the first grid forward "
            f"of the 2 videos through the TP detector against the whole one on this rank "
            f"differs by {g['bf16']:.3e} in bf16 and {g['f32']:.3e} in f32 (tol 1e-4; each "
            f"row-parallel product is summed from two partial products, rounded to the "
            f"compute dtype before the all-reduce) {'OK' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"14c grid difference rank {r}")

    # (d) model = 2: the cut LLaVA-OneVision at 7B widths
    ref = refs["llava"]
    for r, out in enumerate(outs):
        lv = out["llava"]
        err = (lv["logits"] - ref["logits"]).norm() / ref["logits"].norm()
        fused = [0, TP_LM_LAYERS]
        ok = (lv["greedy"] == ref["greedy"] and err.item() <= 2e-2 and lv["eager_reason"]
              and lv["sampled"] == outs[0]["llava"]["sampled"] and lv["captures"] == 0
              and lv["fused_layers"] == fused == ref["fused_layers"])
        log(f"[mesh 1x2 gloo] rank {r}: LLaVA-OneVision at 7B widths (SigLIP 1152 x 27, "
            f"Qwen2 3584 x {TP_LM_LAYERS} of 28 layers (cut), vocab 152064; 14 heads, 2 kv "
            f"heads, 76032 vocabulary rows a rank): f32 greedy tokens equal to one rank's: "
            f"{lv['greedy'] == ref['greedy']}; bf16 next-token logits relative L2 "
            f"{err.item():.3e} (tol 2e-2); sampled (temperature 0.7, seed 5) tokens equal on "
            f"both ranks: {lv['sampled'] == outs[0]['llava']['sampled']}; layers on the "
            f"decode kernels (f32, bf16) {lv['fused_layers']}, one rank "
            f"{ref['fused_layers']} (want {fused}); prefill "
            f"{lv['prefill_ms']:.3f} ms, decode {lv['decode_ms_per_token']:.3f} ms a token "
            f"(eager, every collective staged through the host by gloo; one rank with graphs: "
            f"{ref['decode_ms_per_token']:.3f}); peak {lv['peak_gb']:.2f} GB on this rank "
            f"({card}) {'OK' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"14d rank {r}")
    log(f"[phase 14] two ranks' spawn and run {spawn_s:.1f} s, the phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise SystemExit(f"phase 14 failed: {failed}")
    return {"counts_1x1": counts_1x1, "counts_tp": outs[0]["tp_bf16"]["counts"],
            "llava": {k: outs[0]["llava"][k] for k in ("prefill_ms", "decode_ms_per_token",
                                                       "peak_gb")}}


# ---------------------------------------------------------------------------
# Phase 15: the quantized detector on a tensor-parallel mesh; the
# reference-style baseline
# ---------------------------------------------------------------------------

def int8_search_config(quant="int8"):
    """Phase 6's int8 + verify-512 configuration (or ``quant`` in its place)
    at phase 8's cache and budget."""
    from tstar_tpu_torch import SearchConfig

    return SearchConfig(cache_hw=(192, 384), search_budget=0.5, detector_quant=quant,
                        verify_image_size=512)


def phase_15a(torch, card):
    """Phase 15a: a one-rank NCCL mesh.  Phase 8's bucket of 8 (B/32, bf16)
    under int8 + verify 512 through ``search_videos`` without a mesh, then
    with the detector ``shard_module``d at model = 1 on ``make_mesh(1, 1)``:
    the int8 tower sharded alike, its row-parallel layers (out_proj, fc2) on
    K4's row-parallel mode with their MAX (f32) and SUM (int32) all-reduces
    inside the captured step graphs.  The same keyframes and iterations, the
    same K4 launches (column + row-parallel), two host reads a step.
    Returns the sharded run's launch counts."""
    import torch.distributed as dist

    from tstar_tpu_torch.framework.heuristics import initialize_heuristic
    from tstar_tpu_torch.models.owlvit_quant import route_counts
    from tstar_tpu_torch.parallel import make_mesh, shard_module

    cfg = int8_search_config()
    heur = initialize_heuristic("owl-vit-random", device="cuda", dtype=torch.bfloat16, seed=0)
    # each run twice: the first pays one-time costs (the sharded one the
    # NCCL communicator's set-up), the second is steady
    plain = [_search(torch, heur, cfg, _batched_tasks()) for _ in range(2)]
    del heur
    mesh = make_mesh(1, 1)
    try:
        # a fresh heuristic: the weight views are built once, from the model
        # as it is when the first scorer is made
        heur = initialize_heuristic("owl-vit-random", device="cuda", dtype=torch.bfloat16, seed=0)
        shard_module(heur.model, mesh)
        sharded = [_search(torch, heur, cfg, _batched_tasks(), mesh=mesh) for _ in range(2)]
        routes = route_counts(heur._weight_views[("int8", 512)][0])
    finally:
        dist.destroy_process_group()
    (rows0, st0, c0, wall0), (rows, st, c, wall) = plain[0], sharded[0]
    forwards = st.steps + len(st.verify_widths)
    others = [k for k in c if k not in ("w8a8_matmul", "w8a8_matmul_rowpar")]
    checks = {
        "keyframes and iterations equal": _rows_key(rows) == _rows_key(rows0),
        "routes: 24 column layers on K4, 24 row-parallel on its second mode":
            routes == {"k4": 24, "k4_row": 24},
        "K4 launches equal (column + row-parallel)":
            c["w8a8_matmul"] + c["w8a8_matmul_rowpar"] == c0["w8a8_matmul"] == 48 * forwards,
        "24 column and 24 row-parallel K4 launches a forward":
            c["w8a8_matmul"] == c["w8a8_matmul_rowpar"] == 24 * forwards,
        "every other kernel's launches equal": all(c[k] == c0[k] for k in others),
        "graphs, two host reads a step": all(
            s.replays > 0 and s.host_reads == 2 * s.steps and not s.eager_reason for s in (st0, st)),
        "the second runs alike": all(
            _rows_key(r[1][0]) == _rows_key(rows0) and r[1][2] == r[0][2] for r in (plain, sharded)),
    }
    log(f"[mesh 1x1 int8] phase 8's bucket under int8 + verify 512: {st.steps} steps, "
        f"{forwards} forwards (verify batches {list(st.verify_widths)}); K4 "
        f"{c0['w8a8_matmul']} launches without a mesh, {c['w8a8_matmul']} column + "
        f"{c['w8a8_matmul_rowpar']} row-parallel sharded at model = 1 (routes {routes}); "
        f"{st.replays / st.steps:.2f} graph replays and {st.host_reads / st.steps:.2f} host reads "
        f"a step ({st.captures} captures); walls {wall0:.3f} then {plain[1][3]:.3f} s without a "
        f"mesh, {wall:.3f} then {sharded[1][3]:.3f} s sharded (the first sharded run sets up the "
        f"NCCL communicator) ({card})")
    failed = [k for k, v in checks.items() if not v]
    log(f"[mesh 1x1 int8] checks: {'OK' if not failed else 'FAIL ' + str(failed)}")
    if failed:
        raise SystemExit(f"phase 15a failed: {failed}")
    return {"counts": c, "walls": [wall0, plain[1][3], wall, sharded[1][3]]}


@contextlib.contextmanager
def int8_tower_trace():
    """Records, in ``encode_image_int8``, each LayerNorm's input (the
    residual stream: pre_ln, then ln1 and ln2 of every layer, post_ln,
    merged_ln) and each K1 call's q|k|v and output."""
    from tstar_tpu_torch.models import owlvit_quant

    rec = {"ln": [], "k1": []}
    ln, k1 = owlvit_quant._layernorm, owlvit_quant.fused_mha_from_qkv

    def ln_rec(x, p, eps):
        rec["ln"].append(x.clone())
        return ln(x, p, eps)

    def k1_rec(qkv, heads):
        out = k1(qkv, heads)
        rec["k1"].append((qkv.clone(), out.clone()))
        return out

    owlvit_quant._layernorm, owlvit_quant.fused_mha_from_qkv = ln_rec, k1_rec
    try:
        yield rec
    finally:
        owlvit_quant._layernorm, owlvit_quant.fused_mha_from_qkv = ln, k1


def first_difference(torch, whole, sharded, index, size):
    """Where a rank's int8 tower first parts from the whole one: the first
    LayerNorm input that differs, and whether K1 alone explains it (that
    layer's q|k|v equal to the whole one's sections, its output not)."""
    layers = len(whole["k1"])
    names = (["pre_ln"] + [f"layer {i} {n}" for i in range(layers) for n in ("ln1", "ln2")]
             + ["post_ln", "merged_ln"])
    first = next((i for i, (a, b) in enumerate(zip(whole["ln"], sharded["ln"]))
                  if not torch.equal(a, b)), None)
    if first is None:
        return None

    def local(t, sections):     # rank ``index``'s columns of each section
        w = t.shape[-1] // sections // size
        return torch.cat([s[..., index * w:(index + 1) * w] for s in t.chunk(sections, -1)], -1)

    k1_layers = []
    for layer, ((qkv, out), (qkv_r, out_r)) in enumerate(zip(whole["k1"], sharded["k1"])):
        if torch.equal(local(qkv, 3), qkv_r) and not torch.equal(local(out, 1), out_r):
            k1_layers.append(layer)
    diff = (whole["ln"][first].float() - sharded["ln"][first].float()).abs().max().item()
    k1_alone = bool(k1_layers) and names[first] == f"layer {k1_layers[0]} ln2"
    return {"point": names[first], "diff": diff, "k1_layers": k1_layers, "k1_alone": k1_alone}


# phase 15b's TP searches: (label, detector_quant, dtype name); the f32
# ones are held to one rank's step by step
PHASE15B_SEARCHES = (("int8", "int8", "bfloat16"), ("int8_f32", "int8", "float32"),
                     ("w8a16", "w8a16", "float32"))


def phase15_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One of phase 15b's two ranks on cuda:0 over gloo (model = 2)."""
    import os
    import pickle

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        out = _phase15_rank_body(torch)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _phase15_rank_body(torch):
    from tstar_tpu_torch.framework.heuristics import initialize_heuristic
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.models.owlvit import OwlViTDetector, init_params, owlvit_base_patch32
    from tstar_tpu_torch.models.owlvit_quant import (
        encode_image_int8, quantize_vision_tower, route_counts,
    )
    from tstar_tpu_torch.parallel import make_mesh, shard_module

    dev = torch.device("cuda", 0)
    tp = make_mesh(data=1, model=2, backend="gloo", device=dev)
    out = {}
    # the int8 tower (bf16) on one grid image: 6 heads a rank against 12
    whole = init_params(OwlViTDetector(owlvit_base_patch32()), 0).to(dev, torch.bfloat16)
    sharded = shard_module(
        init_params(OwlViTDetector(owlvit_base_patch32()), 0).to(dev, torch.bfloat16), tp)
    g = torch.Generator(device=dev).manual_seed(15)
    px = torch.randn(1, 768, 768, 3, generator=g, device=dev).to(torch.bfloat16)
    qw, qs = quantize_vision_tower(whole), quantize_vision_tower(sharded)
    with torch.no_grad():
        with int8_tower_trace() as tw:
            fw = encode_image_int8(qw, px, whole.cfg, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        reset_launch_counts()
        with int8_tower_trace() as ts:
            fs = encode_image_int8(qs, px, sharded.cfg, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        counts = launch_counts()
    out["tower"] = {
        "equal": torch.equal(fw, fs), "diff": (fw.float() - fs.float()).abs().max().item(),
        "finite": bool(torch.isfinite(fs).all()), "routes": route_counts(qs),
        "heads": (qs["heads"], whole.cfg.vision.num_heads), "counts": counts,
        "first": first_difference(torch, tw, ts, tp.model_index, tp.model),
    }
    del whole, sharded, qw, qs, tw, ts
    torch.cuda.empty_cache()
    # the int8 search of 2 videos in bf16, then the int8 and the w8a16
    # searches in f32, these two step by step against one rank's on this
    # rank (record=True)
    for label, quant, dtype in PHASE15B_SEARCHES:
        dtype = getattr(torch, dtype)
        cfg = int8_search_config(quant)
        heur = initialize_heuristic("owl-vit-random", device=dev, dtype=dtype, seed=0)
        shard_module(heur.model, tp)
        record = dtype == torch.float32
        rows, stats, counts, wall = _search(torch, heur, cfg, _batched_tasks(2), mesh=tp,
                                            record=record)
        out[label] = {"rows": rows, "steps": stats.steps, "verify": len(stats.verify_widths),
                      "replays": stats.replays, "eager": stats.eager_reason, "counts": counts,
                      "wall": wall,
                      "grid": tp_grid_difference(torch, tp, dev, cfg=cfg,
                                                 dtypes=("f32",) if record else ("bf16",))}
        if record:
            out[label]["parted"] = tp_partings(torch, heur, stats, cfg, dtype, dev)
        del heur
        torch.cuda.empty_cache()
    return out


def tp_partings(torch, heur, stats, cfg, dtype, dev):
    """The TP search (``stats``' trace) against one rank's search of the
    same videos, step by step (``tools/dryrun_multi._compare``): {video: the
    witness of the step where their sampled seconds part, a tie of the
    sampler} (anything else raises), and the largest grid confidence
    difference over the steps that sampled the same seconds."""
    from tstar_tpu_torch.framework.heuristics import initialize_heuristic
    from tstar_tpu_torch.tools.dryrun_multi import _compare

    whole = initialize_heuristic("owl-vit-random", device=dev, dtype=dtype, seed=0)
    rows, whole_stats, _, _ = _search(torch, whole, cfg, _batched_tasks(2), record=True)
    try:
        parted, err, close = _compare(stats.trace, whole_stats.trace, slice(0, 2), cfg)
    except AssertionError as e:      # a parting that is not a tie
        return {"fault": str(e)}
    return {"parted": {f"video {j}": w for j, w in parted.items()}, "conf_err": err,
            "close": close, "rows": rows}


def phase_15b_references(torch):
    """One rank's searches of the 2 videos, as ``PHASE15B_SEARCHES``."""
    from tstar_tpu_torch.framework.heuristics import initialize_heuristic

    refs = {}
    for label, quant, dtype in PHASE15B_SEARCHES:
        heur = initialize_heuristic("owl-vit-random", device="cuda", dtype=getattr(torch, dtype),
                                    seed=0)
        rows, stats, counts, wall = _search(torch, heur, int8_search_config(quant),
                                            _batched_tasks(2))
        refs[label] = {"rows": rows, "wall": wall, "counts": counts,
                       "forwards": stats.steps + len(stats.verify_widths)}
        del heur
    torch.cuda.empty_cache()
    return refs


def phase_15b(torch, card):
    """Phase 15b: two gloo ranks on cuda:0 at model = 2 (B/32, 6 heads a
    rank): the int8 tower against one rank's, bit for bit (else the layer
    where it parts, allowed only where K1's local heads alone explain it);
    an int8 search of 2 videos in bf16 (K4: 24 column and 12 row-parallel
    launches a forward, out_proj's (384, 768) shard in plain ops), its
    keyframes printed beside one rank's; the same search in f32, and under
    w8a16 in f32, held to phase 14c's tolerances (keyframes equal to one
    rank's, or parted at a witnessed tie of the sampler, step by step).
    Returns rank 0's int8 search counts and the walls."""
    import os
    import pickle
    import socket
    import tempfile

    import torch.multiprocessing as mp

    refs = phase_15b_references(torch)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(phase15_rank, args=(2, port, out_dir), nprocs=2, start_method="spawn")
        outs = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
    spawn_s = time.perf_counter() - t0
    failed = []
    for r, out in enumerate(outs):
        t = out["tower"]
        k = t["counts"]
        first = t["first"]
        explained = t["equal"] or (first is not None and first["k1_alone"])
        ok = (explained and t["finite"] and 2 * t["heads"][0] == t["heads"][1]
              and t["routes"] == {"k4": 24, "plain": 12, "k4_row": 12}
              and k["w8a8_matmul"] == 24 and k["w8a8_matmul_rowpar"] == 12
              and k["fused_mha_from_qkv"] == 12)
        where = ("" if t["equal"] else
                 f"; parts first at {first['point']} by {first['diff']:.3e}, K1's outputs differ on "
                 f"equal inputs in layers {first['k1_layers']} (K1's local heads alone: "
                 f"{first['k1_alone']})")
        log(f"[mesh 1x2 gloo int8] rank {r}: B/32's int8 tower (bf16) on one grid image, 6 heads "
            f"a rank, against the whole int8 tower: bit for bit {t['equal']} (max |diff| "
            f"{t['diff']:.3e}){where}; routes {t['routes']}; K4 {k['w8a8_matmul']} column + "
            f"{k['w8a8_matmul_rowpar']} row-parallel launches (want 24 + 12; one rank: 48), K1 "
            f"{k['fused_mha_from_qkv']} {'OK' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"15b tower rank {r}")
        for label, quant, dtype in PHASE15B_SEARCHES:
            s, ref = out[label], refs[label]
            equal = _rows_key(s["rows"]) == _rows_key(ref["rows"])
            forwards = s["steps"] + s["verify"]
            k = s["counts"]
            grid = s["grid"]
            launched = quant == "w8a16" or (k["w8a8_matmul"] == 24 * forwards
                                           and k["w8a8_matmul_rowpar"] == 12 * forwards
                                           and k["fused_mha_from_qkv"] == 12 * forwards)
            ok = launched and s["eager"] and s["replays"] == 0
            held = "" if quant == "w8a16" else (
                f"K4 {k['w8a8_matmul']} column + {k['w8a8_matmul_rowpar']} row-parallel (24 + "
                f"12 a forward; one rank {ref['counts']['w8a8_matmul']} in {ref['forwards']} "
                f"forwards), K1 {k['fused_mha_from_qkv']}; ")
            if dtype == "bfloat16":
                # not held: the float text tower's bf16 partial sums (14c's
                # cause); the f32 search below holds the same path
                held += (f"keyframes and iterations equal to one rank's: {equal} (not held in "
                         f"bf16: the first grid forward differs by {grid['bf16']:.3e}, the float "
                         f"text tower's bf16 partial sums; the f32 search is held)")
            else:
                # phase 14c's tolerances: f32 keyframes equal to one rank's,
                # unless the searches part at a tie of the sampler (the dry
                # run's witness, queue 3 item 11), and the first grid forward
                # within 1e-4
                p = s["parted"]
                tied = "fault" not in p and all(
                    f"video {j}" in p["parted"] for j, (a, b) in enumerate(
                        zip(_rows_key(s["rows"]), _rows_key(p["rows"]))) if a != b)
                ok = ok and (equal or tied) and grid["f32"] <= 1e-4
                held += (f"keyframes and iterations equal to one rank's: {equal}"
                         + ("" if equal else f" (parted: {p.get('fault') or p['parted']})")
                         + f"; grid confidences on the steps that sampled the same seconds up "
                         f"to {p.get('conf_err', float('nan')):.3e} apart; the first grid forward "
                         f"differs by {grid['f32']:.3e} (tol 1e-4, phase 14c's)")
            log(f"[mesh 1x2 gloo {quant}] rank {r}: {quant} + verify 512 TP search of 2 videos "
                f"({'bf16' if dtype == 'bfloat16' else 'f32'}): {s['steps']} steps, "
                f"{forwards} forwards, eager ({s['eager'][:40]}...); {held}; wall {s['wall']:.3f} s against one rank's "
                f"{ref['wall']:.3f} s with graphs ({card}) {'OK' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"15b {label} search rank {r}")
    log(f"[phase 15b] two ranks' spawn and run {spawn_s:.1f} s")
    if failed:
        raise SystemExit(f"phase 15b failed: {failed}")
    return {"counts": outs[0]["int8"]["counts"], "wall": outs[0]["int8"]["wall"],
            "int8_f32_wall": outs[0]["int8_f32"]["wall"],
            "w8a16_wall": outs[0]["w8a16"]["wall"], "ref_wall": refs["int8"]["wall"]}


def phase_15c(torch, card):
    """Phase 15c: ``reference_style_search`` (the original TStar's host loop:
    numpy sampling, the grid built on the host, one forward on the card,
    detections back with ``.cpu()``, the host splat and scipy spline) with a
    B/32 bf16 forward at 768^2 on phase 5's 600 s video: frames scored,
    wall, frames/s, the forward's launches; its host grid within one level
    of the device grid builder's."""
    import numpy as np

    from tstar_tpu_torch import SearchConfig
    from tstar_tpu_torch.bench.reference_style import host_grid, reference_style_search
    from tstar_tpu_torch.framework.heuristics import initialize_heuristic
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.kernels.image import CLIP_MEAN, CLIP_STD, build_detector_grid
    from tstar_tpu_torch.models.owlvit import postprocess_detections
    from tstar_tpu_torch.video.cache import build_frame_cache_host
    from tstar_tpu_torch.video.synthetic import default_scene

    cfg = SearchConfig(cache_hw=(192, 384), search_budget=0.5)
    heur = initialize_heuristic("owl-vit-random", device="cuda", dtype=torch.bfloat16, seed=0)
    host = build_frame_cache_host("mem://synthetic-600s", cfg, decoder=default_scene(600.0))
    cache = torch.from_numpy(host.frames).cuda()
    scorer = heur.build_scorer(cache, ["couch", "lamp"], ["tv"], cfg)
    model = heur.model

    @torch.no_grad()
    def forward(pixels):
        feats = model.encode_image(pixels.to(torch.bfloat16))
        logits, boxes = model.predict(feats, scorer.query_embeds, scorer.query_mask)
        return postprocess_detections(logits, boxes, (768, 768))

    weights = scorer.class_weights.cpu().numpy()
    args = (forward, host.frames, host.n_valid, weights, 2, cfg)
    reference_style_search(*args, device="cuda")      # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    frames, wall = reference_style_search(*args, device="cuda")
    counts = launch_counts()
    forwards = frames // 16
    secs = np.arange(16) * (host.n_valid // 16)
    grid = host_grid(host.frames, secs, 4, 4, 768).astype(np.float32)
    dev_grid = build_detector_grid(cache, torch.from_numpy(secs).cuda(), (4, 4), 768,
                                   torch.float32)[0].cpu().numpy()
    levels = (dev_grid * CLIP_STD + CLIP_MEAN) * 255.0
    grid_diff = float(np.abs(levels - grid).max())
    want = launches(fused_mha_from_qkv=12, patch_embed_matmul=1, fused_layernorm=27)
    ok = (frames == cfg.budget_frames(host.n_valid) + (-cfg.budget_frames(host.n_valid)) % 16
          and all(counts[k] == n * forwards for k, n in want.items()) and grid_diff <= 1.0 + 1e-3)
    log(f"[reference style] the original's host loop on the 600 s video, B/32 bf16 at 768^2: "
        f"{frames} frames scored in {forwards} forwards, wall {wall:.3f} s, "
        f"{frames / wall:.1f} frames/s; launches K1 {counts['fused_mha_from_qkv']}, K2 "
        f"{counts['patch_embed_matmul']}, K3 {counts['fused_layernorm']} (12 / 1 / 27 a "
        f"forward); the host grid against the device grid builder's: {grid_diff:.4f} levels "
        f"(tol 1) ({card}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 15c failed")
    return {"frames": frames, "wall": wall, "fps": frames / wall, "grid_levels": grid_diff}


def phase_15(torch, card):
    """Phase 15 (module docstring).  Returns 15a's launch counts, 15b's int8
    TP search counts and walls, and 15c's baseline."""
    t0 = time.perf_counter()
    mesh_1x1 = phase_15a(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    tp = phase_15b(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    baseline = phase_15c(torch, card)
    log(f"[phase 15] {time.perf_counter() - t0:.1f} s")
    return {"counts_1x1": mesh_1x1["counts"], "walls_1x1": mesh_1x1["walls"], "tp": tp,
            "baseline": baseline}


def kimi_a3b(torch, card):
    """Kimi-VL-A3B-Instruct at its published widths (MoonViT 1152 x 27, 27
    decoder layers of 2048, 64 experts of 1408, 6 a token, 2 shared, vocab
    163840), seeded on the card in bf16 one weight at a time
    (``kimi_vl.seeded_weight``, in ``load_weights``' order), and a
    byte-level tokenizer at Kimi-VL's special ids."""
    import tempfile

    from tstar_tpu_torch.models import kimi_vl

    cfg = kimi_vl.KimiVLConfig()
    shapes = dict(kimi_vl.flat_weight_shapes(cfg))
    gen = torch.Generator(device="cuda").manual_seed(0)

    class Draws:
        def __getitem__(self, name):
            return kimi_vl.seeded_weight(name, shapes[name], gen, torch.bfloat16)

    t0 = time.perf_counter()
    model = kimi_vl.kimi_model_from(cfg, Draws(), torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[kimi] Kimi-VL-A3B at its published widths: {n_params / 1e9:.3f} B parameters, "
        f"{n_params * 2 / 1e9:.2f} GB bf16, seeded on the card in "
        f"{time.perf_counter() - t0:.2f} s ({card})")
    with tempfile.TemporaryDirectory() as tmp:
        tok = byte_tokenizer(tmp, kimi_vl.KIMI_SPECIAL_TOKENS)
    return model, tok


def step_graph_launches(torch, bucket):
    """(kernel nodes, all nodes) of one more capture of ``bucket``'s decode
    step, kept as a CUDA graph (``keep_graph``) and walked with the driver's
    ``cuGraphGetNodes`` / ``cuGraphNodeGetType``: the launches a replayed
    step runs.  The capture runs nothing; the launches it adds to the
    wrappers' counts are taken back."""
    import ctypes

    from tstar_tpu_torch.kernels import add_launch_counts, launch_counts

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    before = launch_counts()
    stream = bucket.graphs.stream
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            bucket.body()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    add_launch_counts({k: before[k] - v for k, v in launch_counts().items() if v != before[k]})
    cuda = ctypes.CDLL("libcuda.so.1")
    handle, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) != 0:
        raise SystemExit("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) != 0:
        raise SystemExit("cuGraphGetNodes failed")
    kernels = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise SystemExit("cuGraphNodeGetType failed")
        kernels += kind.value == 0          # CU_GRAPH_NODE_TYPE_KERNEL
    del graph
    return kernels, count.value


def phase_16(torch, card):
    """Phase 16: Kimi-VL-A3B (``kimi_a3b``) serves two grounding requests as
    a user's are served: ``TorchVLMBackend.from_model`` -> ``generate``, 8
    frames of 360 x 640 at native resolution (299 tokens each), the
    framework's 512-token cap, temperature 0.  The first request captures
    its bucket's decode step; the second, of the same bucket, only replays
    it.  Each request's launches, counted from zero, must hold the router
    (M1, ``moe_route``) and the experts (M2, ``moe_decode``) 26 times a
    decode step and the latent attention (``mla_decode``) 27 times, eager,
    captured or replayed, and ``GenerateStats.step_launches`` must read 26
    ``moe_decode`` and 27 ``mla_decode`` launches a step; a replay under
    ``set_sync_debug_mode('error')`` (a host read raises) runs.  Prints each
    kernel's launches a step as measured, the launches of the whole step
    (the kernel nodes of its graph: at most 300), the expert_tokens skew,
    the device times and the peak memory."""
    from tstar_tpu_torch.grounding.prompts import build_grounding_prompt
    from tstar_tpu_torch.grounding.vlm_backend import TorchVLMBackend
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.models.generate import GenerateStats
    from tstar_tpu_torch.utils.images import load_video_frames
    from tstar_tpu_torch.video.synthetic import default_scene, scene_variant

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, tok = kimi_a3b(torch, card)
    moe, layers = model.cfg.text.moe_layers, model.cfg.text.num_layers
    backend = TorchVLMBackend.from_model(model, tok)
    prompt = build_grounding_prompt(QA_QUESTION, QA_OPTIONS, 8)
    rows = []
    for label, scene in (("first (captures)", default_scene(600.0)),
                         ("second (replays)", scene_variant(3))):
        stats = backend.stats = GenerateStats(timed=True)
        frames = load_video_frames("mem://scene", 8, decoder=scene)
        prompt_tokens = int(backend._prepare(prompt, frames)["prompt_lens"][0])
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        backend.inference_with_frames(prompt, frames, temperature=0.0, max_tokens=512)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = {k: v for k, v in launch_counts().items() if v}
        steps = stats.decode_steps
        rows.append({"request": label, "frames_hw": list(frames[0].shape[:2]),
                     "prompt_tokens": prompt_tokens,
                     "decode_steps": steps, "captures": stats.captures,
                     "replays": stats.replays, "flag_reads": stats.flag_reads,
                     "step_launches": dict(stats.step_launches), "launches": counts,
                     "per_step": {k: counts.get(k, 0) / max(steps, 1)
                                  for k in ("moe_route", "moe_decode", "mla_decode",
                                            "add_rms_norm", "silu_mul", "decode_attention")},
                     "request_s": wall, "prefill_ms": stats.prefill_ms[-1],
                     "decode_ms": stats.decode_ms[-1]})
        log(f"[kimi] grounding request, {label}: " + json.dumps(rows[-1]))
    first, second = rows
    ok = (all(r["decode_steps"] >= 1 and r["step_launches"].get("moe_decode") == moe
              and r["step_launches"].get("mla_decode") == layers
              and r["launches"].get("moe_route", 0) == moe * r["decode_steps"]
              and r["launches"].get("moe_decode", 0) == moe * r["decode_steps"]
              and r["launches"].get("mla_decode", 0) == layers * r["decode_steps"] for r in rows)
          and first["captures"] == 1 and second["captures"] == 0
          and second["replays"] == second["decode_steps"]
          and first["prompt_tokens"] == second["prompt_tokens"])
    log(f"[kimi] moe_route / moe_decode launches a decode step: "
        f"{first['per_step']['moe_route']} / {first['per_step']['moe_decode']} and "
        f"{second['per_step']['moe_route']} / {second['per_step']['moe_decode']} "
        f"(want {moe} / {moe}); step_launches moe_decode "
        f"{first['step_launches'].get('moe_decode')} / {second['step_launches'].get('moe_decode')} "
        f"(want {moe}); captures {first['captures']} / {second['captures']} (want 1 / 0); "
        f"mla_decode launches a decode step {first['per_step']['mla_decode']} / "
        f"{second['per_step']['mla_decode']}, step_launches mla_decode "
        f"{first['step_launches'].get('mla_decode')} / "
        f"{second['step_launches'].get('mla_decode')} (want {layers}); add_rms_norm (D1) a step "
        f"{first['per_step']['add_rms_norm']} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 16: Kimi-VL's decode did not take the MoE and MLA kernels in "
                         "every layer of every step")
    (bucket,) = [b for b in model._decode_buckets.values() if "step" in b.graphs]
    step_kernels, step_nodes = step_graph_launches(torch, bucket)
    log(f"[kimi] launches a decode step: {step_kernels} kernel nodes of {step_nodes} in the "
        f"step's graph (want <= 300) {'OK' if step_kernels <= 300 else 'FAIL'}")
    if step_kernels > 300:
        raise SystemExit("phase 16: a Kimi-VL decode step launches more than 300 kernels")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        bucket.run_step(GenerateStats())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("[kimi] a decode replay raised nothing under torch.cuda.set_sync_debug_mode('error') OK")
    counts = model.expert_tokens.float()
    share = counts / counts.sum(dim=1, keepdim=True)
    skew = {"pairs": int(counts.sum()), "busiest_share_mean": share.max(1).values.mean().item(),
            "busiest_share_max": share.max().item(), "least_share_min": share.min().item(),
            "uniform": 1 / counts.shape[1]}
    peak = torch.cuda.max_memory_allocated()
    log(f"[kimi] expert_tokens {json.dumps(skew)}; peak memory {peak / 1e9:.2f} GB; "
        f"phase 16 wall {time.perf_counter() - t_phase:.1f} s ({card})")
    del bucket, backend, model
    return {"requests": rows, "skew": skew, "peak_gb": peak / 1e9,
            "step_launches": step_kernels, "step_nodes": step_nodes}


def log_allocated(torch, phase):
    """What earlier phases left allocated, which each later phase's peak
    memory includes (phases 10b and 11 count theirs above it)."""
    log(f"[memory] {torch.cuda.memory_allocated() / 2**20:.1f} MiB allocated as {phase} begins")


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

    from tstar_tpu_torch.framework.heuristics import initialize_heuristic

    phase_build(torch)
    rows = phase_kernels(torch, card)
    tower = phase_tower(torch)
    phase_int8_tower(torch, tower)
    phase_route_tower(torch, tower)
    phase_widths(torch, tower)
    del tower
    heur = initialize_heuristic("owl-vit-random", device="cuda", dtype=torch.bfloat16, seed=0)
    counts = phase_slice(torch, card, heur)
    knobs = phase_knobs(torch, card, heur)
    routes = phase_routes(torch, card, heur)
    phase_k6_trace(torch, card, heur)
    batched_counts, batched_k6 = phase_batched(torch, card, heur)
    del heur
    gc.collect()
    torch.cuda.empty_cache()
    log_allocated(torch, "phase 9")
    vlm, vlm_7b_model = phase_vlm(torch, card)
    # phase 11 keeps the 7B model's weights, not its decode buckets
    vlm_7b_model[0]._decode_buckets.clear()
    log("[vlm] " + json.dumps(vlm))
    gc.collect()
    torch.cuda.empty_cache()
    log_allocated(torch, "phase 10")
    p10 = phase_10(torch, card)
    log("[yolo] " + json.dumps({k: p10[k] for k in ("nms", "yolo", "batched_dtype")}))
    log_allocated(torch, "phase 11")
    p11 = phase_11(torch, card, vlm_7b_model, p10.pop("heuristic"))
    del vlm_7b_model
    gc.collect()
    torch.cuda.empty_cache()
    log("[pipeline] " + json.dumps(p11["rows"]))
    log_allocated(torch, "phase 12")
    p12 = phase_12(torch, card)
    log("[streaming] " + json.dumps({k: p12[k] for k in ("long", "verify", "busy")}))
    gc.collect()
    torch.cuda.empty_cache()
    log_allocated(torch, "phase 13")
    p13 = phase_13(torch, card)
    log("[phase 13] " + json.dumps({k: p13[k] for k in ("calibration", "qwen25", "anyres")},
                                   default=str))
    gc.collect()
    torch.cuda.empty_cache()
    log_allocated(torch, "phase 14")
    p14 = phase_14(torch, card)
    log("[phase 14] " + json.dumps(p14["llava"]))
    gc.collect()
    torch.cuda.empty_cache()
    log_allocated(torch, "phase 15")
    p15 = phase_15(torch, card)
    walls = ("wall", "int8_f32_wall", "w8a16_wall", "ref_wall")
    log("[phase 15] " + json.dumps({k: p15["tp"][k] for k in walls}
                                   | {"baseline": p15["baseline"]}))
    gc.collect()
    torch.cuda.empty_cache()
    log_allocated(torch, "phase 16")
    p16 = phase_16(torch, card)
    if "triton" in sys.modules:
        raise SystemExit("triton was imported: the port has no Triton kernel")
    log("[routes] triton was never imported")

    # name, route, source, TPU kernel, launches (from the run of its path),
    # the device kernel that implements it in bf16
    meta = {
        "K1": ("fused_mha_from_qkv", "cuda", "tstar_tpu_torch/csrc/attn_sm90.cu",
               "tstar_tpu/kernels/attention.py:298", counts["fused_mha_from_qkv"],
               "attn_sm90_kernel (wgmma + TMA)"),
        "K2": ("patch_embed_matmul", "cuda", "tstar_tpu_torch/csrc/patch_embed.cu",
               "tstar_tpu/kernels/patch_matmul.py:76", counts["patch_embed_matmul"],
               "patch_embed_sm90_kernel (wgmma + TMA)"),
        "K3": ("fused_layernorm", "cuda", "tstar_tpu_torch/csrc/layernorm.cu",
               "tstar_tpu/kernels/layernorm.py:126", counts["fused_layernorm"],
               "layernorm_kernel (a warp a row)"),
        "K4": ("w8a8_matmul", "cuda", "tstar_tpu_torch/csrc/w8a8.cu",
               "tstar_tpu/kernels/quant_matmul.py:64", knobs["int8+verify512"]["w8a8_matmul"],
               "w8a8_kernel (integer wgmma + TMA, clusters)"),
        "K5": ("ln_matmul", "cuda", "tstar_tpu_torch/csrc/ln_matmul.cu",
               "tstar_tpu/kernels/ln_matmul.py:86", knobs["ln_matmul"]["ln_matmul"],
               "ln_matmul_kernel (wgmma + TMA, clusters)"),
        "K6": ("grid_cell_embed", "cuda", "tstar_tpu_torch/csrc/grid_embed.cu",
               "tstar_tpu/kernels/grid_embed.py:181", routes["k6 grid embed"]["grid_cell_embed"],
               "grid_embed_sm90_kernel (wgmma + TMA, A built in shared memory, clusters splitting K)"),
        "K7": ("build_detector_grid_pallas", "cuda", "tstar_tpu_torch/csrc/grid_pack.cu",
               "tstar_tpu/kernels/pallas_grid.py:141",
               routes["k7 pallas preprocess"]["build_detector_grid_pallas"],
               "grid_pack_kernel (two canvas rows a CTA)"),
        "K8": ("flash_mha", "cuda", "tstar_tpu_torch/csrc/attn_sm90.cu",
               "tstar_tpu/kernels/attention.py:621", routes["k8 flash"]["flash_mha"],
               "attn_sm90_kernel (wgmma + TMA)"),
    }
    kernels = []
    for k, (name, route, source, replaces, launches, impl) in meta.items():
        mine = [r for r in rows if r["kernel"] == k]
        main_row = mine[0]    # the B=1 grid forward's shape: most of the launches
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "impl": impl, "launches": launches,
            "max_abs_err": max(r["err"] for r in mine),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "yardsticks_ms": main_row["yardsticks"],
            "shape": f"{main_row['shape']} {main_row['dtype']}",
            # phase 8's B=8 search (K6: under TSTAR_GRID_EMBED=1)
            "launches_batched": (batched_k6 if k == "K6" else batched_counts)[name],
            # phase 9's full-width QA request: K3 in SigLIP, no other kernel
            "launches_vlm_request": vlm["k3_launches_per_request"] if k == "K3" else 0,
            # phase 10b's YOLO-World v2-XL search: K3 in the prompts' text encode
            "launches_yolo_search": p10["counts"][name],
            # phase 11a / 11b: run() of the T* pipeline (grounding, search, QA)
            "launches_pipeline": p11["counts"]["owl"][name],
            "launches_pipeline_yolo": p11["counts"]["yolo"][name],
            # phase 12a: the streaming search of phase 5's video
            "launches_streaming": p12["counts"][name],
            # phase 13a: phase 5's search with the calibrated B/32 scorer
            "launches_calibrated": p13["counts"][name],
            # phase 13f: LLaVA-OneVision's anyres image at SigLIP's widths
            "launches_anyres": p13["anyres"]["counts"][name],
            # phase 13b: the knob A/B at its own geometry, by knob
            "launches_knob_ab": {knob: e["launches"].get(name, 0)
                                 for knob, e in p13["knob_ab"]["knobs"].items()},
            # phase 14a: phase 8's bucket, detector sharded over a one-rank
            # NCCL mesh; 14c: rank 0's bf16 search of 2 videos at model = 2
            "launches_mesh_1x1": p14["counts_1x1"][name],
            "launches_tp_search": p14["counts_tp"][name],
            # phase 15a: phase 8's bucket under int8 + verify 512, sharded
            # over a one-rank NCCL mesh; 15b: rank 0's int8 TP search (K4:
            # the first mode; its row-parallel mode under launches_rowpar)
            "launches_mesh_int8_1x1": p15["counts_1x1"][name],
            "launches_tp_int8": p15["tp"]["counts"][name],
        })
        if k in ("K1", "K5"):
            kernels[-1]["tp_rows"] = [
                {key: r[key] for key in ("shape", "dtype", "ms", "plain_ms", "library_ms",
                                         "yardsticks", "bound_ms", "bound_by", "err")}
                for r in mine if "TP" in r["shape"]]
        if k == "K4":
            # the row-parallel mode: its phase 3 rows, and its launches (and
            # the first mode's) in phase 15a's sharded int8 bucket and in
            # 15b's int8 TP search (rank 0)
            kernels[-1]["rowpar_rows"] = [
                {key: r[key] for key in ("shape", "dtype", "ms", "plain_ms", "library_ms",
                                         "yardsticks", "bound_ms", "bound_by", "err")}
                for r in mine if r["shape"].startswith("row-parallel")]
            kernels[-1]["launches_rowpar"] = {
                "mesh_int8_1x1": p15["counts_1x1"]["w8a8_matmul_rowpar"],
                "tp_int8": p15["tp"]["counts"]["w8a8_matmul_rowpar"]}
        if k == "K3":
            sig = [r for r in mine if r["shape"] == "5832x1152" and r["dtype"] == "bf16"][0]
            kernels[-1]["vlm_row"] = {key: sig[key] for key in (
                "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "err")}
    # D1-D3, the decode step's kernels: launches a decode step of the 28
    # layers, as phases 9a, 11 and 13e hold them (decode_launches)
    for k, name, impl, per_step in (
            ("D1", "add_rms_norm", "add_rms_norm_kernel (a CTA a row)", 57),
            ("D2", "decode_attention",
             "decode_attn_kernel<G> (a cluster of CTAs a (row, kv head), mma.sync)", 28),
            ("D3", "silu_mul", "silu_mul_kernel (8 values a thread)", 28)):
        mine = [r for r in rows if r["kernel"] == k]
        kernels.append({
            "name": name, "route": "cuda", "source": "tstar_tpu_torch/csrc/decode_layer.cu",
            "replaces": "none (XLA: the reference's Qwen2 decoder layer)", "impl": impl,
            "launches_per_decode_step": per_step, "max_abs_err": max(r["err"] for r in mine),
            "rows": [{key: r[key] for key in ("shape", "ms", "plain_ms", "yardsticks", "bound_ms",
                                              "bound_by", "err")} for r in mine],
        })
    # M1-M2, Kimi-VL's router and experts: launches a decode step of its 26
    # MoE layers, as phase 16's two grounding requests measured them
    for k, name, impl in (
            ("M1", "moe_route", "moe_route_kernel (8 CTAs a token, the last picks the top K)"),
            ("M2", "moe_decode", "moe_decode_up_kernel + moe_decode_down_kernel (each expert "
                                 "read once a step)")):
        mine = [r for r in rows if r["kernel"] == k]
        kernels.append({
            "name": name, "route": "cuda", "source": "tstar_tpu_torch/csrc/moe_decode.cu",
            "replaces": "none (the reference has no MoE model)", "impl": impl,
            "launches_per_decode_step": [r["per_step"][name] for r in p16["requests"]],
            "max_abs_err": max(r["err"] for r in mine),
            "rows": [{key: r[key] for key in ("shape", "ms", "plain_ms", "yardsticks", "bound_ms",
                                              "bound_by", "err")} for r in mine],
        })
    # MLA, Kimi-VL's latent attention: launches a decode step of its 27 layers
    mine = [r for r in rows if r["kernel"] == "MLA"]
    kernels.append({
        "name": "mla_decode", "route": "cuda", "source": "tstar_tpu_torch/csrc/mla_decode.cu",
        "replaces": "none (the reference has no MLA model)",
        "impl": "mla_q_kernel + mla_attend_kernel (flash-decoding over ~128 CTAs, TMA, mma.sync) "
                "+ mla_out_kernel (clusters of 8 a head)",
        "launches_per_decode_step": [r["per_step"]["mla_decode"] for r in p16["requests"]],
        "step_launches": p16["step_launches"], "max_abs_err": max(r["err"] for r in mine),
        "rows": [{key: r[key] for key in ("shape", "ms", "plain_ms", "yardsticks", "bound_ms",
                                          "bound_by", "err")} for r in mine],
    })
    nms = p10["nms"]
    kernels.append({
        "name": "greedy_nms", "route": "cuda", "source": "tstar_tpu_torch/csrc/nms.cu",
        "replaces": "tstar_tpu/ops/nms.py:33 (XLA loop, not Pallas)",
        "impl": "nms_mask_kernel (upper-triangle IoU bitmask) + nms_scan_kernel (a warp an image)",
        "launches": p10["counts"]["greedy_nms"], "max_abs_err": max(r["err"] for r in nms),
        "ms": nms[0]["ms"], "plain_ms": nms[0]["plain_ms"], "bound_ms": nms[0]["bound_ms"],
        "bound_by": nms[0]["bound_by"], "library_ms": None, "shape": nms[0]["shape"],
        "rows_b8_full": nms[1:], "registers": nms[0]["registers"], "spills": nms[0]["spills"],
        "launches_batched": p10["batched_counts"]["greedy_nms"], "launches_vlm_request": 0,
        "launches_yolo_search": p10["counts"]["greedy_nms"],
        "launches_pipeline": p11["counts"]["owl"]["greedy_nms"],
        "launches_pipeline_yolo": p11["counts"]["yolo"]["greedy_nms"],
        "launches_streaming": p12["counts"]["greedy_nms"],
        "launches_calibrated": p13["counts"]["greedy_nms"],
        "launches_anyres": p13["anyres"]["counts"]["greedy_nms"],
        "launches_knob_ab": {knob: e["launches"].get("greedy_nms", 0)
                             for knob, e in p13["knob_ab"]["knobs"].items()},
        "launches_mesh_1x1": p14["counts_1x1"]["greedy_nms"],
        "launches_tp_search": p14["counts_tp"]["greedy_nms"],
        "launches_mesh_int8_1x1": p15["counts_1x1"]["greedy_nms"],
        "launches_tp_int8": p15["tp"]["counts"]["greedy_nms"],
    })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
