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
In phases 5-8 every kernel's launches must equal its launches per grid and
per verification forward times those forwards (a CUDA graph's replay counts
the launches its capture recorded), and the searches step through graphs
with two host reads a step.
The second-to-last line is a JSON object of per-kernel results (K1-K8 with
their launches in phase 10b's YOLO search, and the NMS kernel); the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
    # wgmma n = 128, or 64-row with n = 64), each on integer wgmma fed by TMA.
    w8a8 = sorted(n for n in bodies if "w8a8_kernel" in n)
    for name in w8a8:
        m = re.search(r"w8a8_kernelI(\w+?)(S1_|f|13__nv_bfloat16)Li(\d)E", name)
        label = f"K4 w8a8_kernel {name}" if not m else (
            f"K4 w8a8_kernel x {'f32' if m.group(1) == 'f' else 'bf16'} -> "
            f"{'f32' if m.group(2) == 'f' else 'bf16'}, {64 * int(m.group(3))}-row slab")
        if not sass_check(name, label, ("IGMMA", "UTMALDG")):
            failed.append(label)
    if len(w8a8) != 8 or failed:
        raise SystemExit(f"K4 kernels: {len(w8a8)} found (want 8), failing {failed}")
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
        ms, plain_ms = cuda_ms(c.run), cuda_ms(c.plain)
        lib_ms = cuda_ms(c.library) if c.library is not None else None
        yard = {k: cuda_ms(fn) for k, fn in c.yardsticks.items()}
        b_ms, b_by = bound_ms(c.n_bytes, c.n_ops, c.kind)
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        extra = "".join(f" {k}={v:.4f} ms" for k, v in yard.items())
        log(f"[kernels] {c.kernel} {c.shape} {c.dtype}: max_abs_err={err:.3e} tol={tol} "
            f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms library={lib}{extra} "
            f"bound={b_ms:.4f} ms ({b_by}: {c.n_bytes / 1e6:.2f} MB, {c.n_ops / 1e9:.3f} GOP) "
            f"({card}) {'OK' if ok else 'FAIL'}")
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
    from tstar_tpu_torch.models.owlvit_quant import encode_image_int8, quantize_vision_tower

    cfg, cpu_model, gpu_model = tower["cfg"], tower["cpu_model"], tower["gpu_model"]
    qp_cpu = quantize_vision_tower(cpu_model)   # from the f32 weights, for both sides

    def to_cuda(tree):
        if isinstance(tree, dict):
            return {k: to_cuda(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(to_cuda(v) for v in tree)
        return tree.to("cuda")

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
          and counts["w8a8_matmul"] == 4 * cfg.vision.num_layers)
    log(f"[int8 tower] B/32 full width, one 768^2 grid image: K4 launches {counts['w8a8_matmul']} "
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


def vlm_full_width(torch, card):
    """Phase 9a: one QA request at LLaVA-OneVision-7B's widths, bf16, with
    graphs and eager; a second request of the same bucket, sent through
    ``UniversalGrounder.inference_qa`` on the same model; K3 54 times a
    request, no other kernel; a replay under the sync debug mode."""
    import tempfile

    from tstar_tpu_torch.grounding.prompts import build_qa_prompt
    from tstar_tpu_torch.grounding.universal import UniversalGrounder
    from tstar_tpu_torch.grounding.vlm_backend import TorchVLMBackend
    from tstar_tpu_torch.kernels import launch_counts, reset_launch_counts
    from tstar_tpu_torch.models.generate import GenerateStats, generate
    from tstar_tpu_torch.models.llava_onevision import (
        LlavaOnevisionConfig, LlavaOnevisionModel, prepare_llava_inputs,
    )
    from tstar_tpu_torch.models.qwen2vl import random_model
    from tstar_tpu_torch.utils.images import load_video_frames
    from tstar_tpu_torch.video.synthetic import default_scene, scene_variant

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
              if k != "fused_layernorm" and v}
    ok = (graph_tokens == eager_tokens and captures == 1 and backend.stats.captures == 0
          and backend.stats.replays >= 1 and isinstance(answer, str)
          and counts["fused_layernorm"] == 54 == second_counts["fused_layernorm"] and not others
          and len(graph_tokens[0]) == 30 and int(inp2["prompt_lens"][0]) == s)
    stats = backend.stats
    log(f"[vlm] QA request, 8 frames of a synthetic 600 s video, prompt {s} tokens "
        f"({8 * cfg.tokens_per_frame + 1} video), 30 new tokens, greedy: graph tokens == eager "
        f"tokens: {graph_tokens == eager_tokens} ({graph_tokens[0][:6]}...); captures: first "
        f"request {captures}, second request of the bucket (UniversalGrounder.inference_qa, "
        f"answer {answer[:24]!r}) {stats.captures}; K3 launches {counts['fused_layernorm']} / "
        f"{second_counts['fused_layernorm']} a request (want 54), other kernels "
        f"{others or 'none'} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 9a: the full-width VLM request failed its checks")

    # a replay synchronizes nothing (the flag read is outside it)
    (bucket,) = [b for b in model._decode_buckets.values() if b.graph is not None]
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
    del model, bucket, dev, pixels, backend, grounder
    gc.collect()              # the model and its decode buckets refer to each other
    torch.cuda.empty_cache()
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


def vlm_facade(torch, card):
    """Phase 9c: a tiny checkpoint of each family written here (config.json,
    byte vocabulary, model.safetensors), loaded through ``UniversalGrounder``
    onto the card and onto the CPU in f32: at temperature 0 the QA, grounding
    and (Qwen2-VL) batched QA strings agree, and the batch equals the serial
    calls."""
    import tempfile

    import numpy as np

    from tstar_tpu_torch.grounding.universal import UniversalGrounder
    from tstar_tpu_torch.models.llava_onevision import LlavaOnevisionConfig, LlavaOnevisionModel
    from tstar_tpu_torch.models.loader import save_vlm_checkpoint
    from tstar_tpu_torch.models.qwen2vl import (
        Qwen2VLConfig, Qwen2VLModel, Qwen2VLTextConfig, Qwen2VLVisionConfig, init_random_,
    )
    from tstar_tpu_torch.models.qwen_tokenizer import SPECIAL_TOKENS
    from tstar_tpu_torch.models.siglip import SiglipVisionConfig
    from tstar_tpu_torch.video.synthetic import default_scene

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
    scene = default_scene(600.0)
    rng = np.random.default_rng(0)
    items = [{"frames": [rng.integers(0, 256, (360, 640, 3), np.uint8) for _ in range(2)],
              "question": f"What {'is it ' * i}?", "options": QA_OPTIONS} for i in range(4)]
    for family, model in models.items():
        init_random_(model, torch.Generator().manual_seed(3))
        with tempfile.TemporaryDirectory() as d:
            save_vlm_checkpoint(model, d)
            byte_tokenizer(d, special)
            answers = {}
            for device in ("cuda", "cpu"):
                g = UniversalGrounder(f"{family}-tiny", model_path=d, device=device,
                                      dtype=torch.float32)
                g.backend.max_pixels = 56 * 56
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
            raise SystemExit(f"phase 9c: the {family} grounder on the card differs from the CPU")


def phase_vlm(torch, card):
    """Phase 9: the VLM stages (a) at full width, (b) numerics, (c) the facade."""
    t0 = time.perf_counter()
    with torch.no_grad():
        row = vlm_full_width(torch, card)
        vlm_numerics(torch, card)
        vlm_facade(torch, card)
    log(f"[vlm] phase 9 wall {time.perf_counter() - t0:.1f} s ({card})")
    return row


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


def phase_yolo(torch, card):
    """Phase 10b: YOLO-World v2-XL at full width, one video (module
    docstring).  Returns (heuristic, row of numbers, launch counts)."""
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
        f"{peak / 2**20:.1f} MiB; {st.host_reads / st.steps:.2f} host reads, "
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
    row = {"forward": fwd, "search_wall_s": wall, "eager_wall_s": e_wall, "peak_mib": peak / 2**20,
           "grid": st.steps, "verify": st.verify_widths, "anchors_above": above}
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
    nms_rows = phase_nms(torch, card)
    gc.collect()
    torch.cuda.empty_cache()      # the plain version's (B, N, N) IoU tensors
    yolo, row, counts = phase_yolo(torch, card)
    batched_counts, batched_dtype = phase_yolo_batched(torch, card, yolo)
    phase_yolo_numerics(torch, card)
    phase_checkpoints(torch, card, yolo)
    del yolo
    torch.cuda.empty_cache()
    log(f"[yolo] phase 10 wall {time.perf_counter() - t0:.1f} s ({card})")
    return {"nms": nms_rows, "yolo": row, "counts": counts, "batched_counts": batched_counts,
            "batched_dtype": batched_dtype}


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
    torch.cuda.empty_cache()
    vlm = phase_vlm(torch, card)
    log("[vlm] " + json.dumps(vlm))
    gc.collect()
    torch.cuda.empty_cache()
    p10 = phase_10(torch, card)
    log("[yolo] " + json.dumps({k: p10[k] for k in ("nms", "yolo", "batched_dtype")}))
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
        })
        if k == "K3":
            sig = [r for r in mine if r["shape"] == "5832x1152" and r["dtype"] == "bf16"][0]
            kernels[-1]["vlm_row"] = {key: sig[key] for key in (
                "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "err")}
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
    })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
