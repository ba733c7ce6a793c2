"""The bf16 attention kernel of K1 and K8 (``csrc/attn_sm90.cu``) on one GPU:
its grid choice and where K8 rounds.

    python -m tstar_tpu_torch.tools.attn_bench [--old-checkout DIR] [--out FILE.json]

1. Grid choice.  The library is built twice more with the query rows per CTA
   pinned (``-DTSTAR_ATTN_WGS=1``: one consumer warpgroup, 64 rows; ``=2``:
   two warpgroups, 128 rows), and K1 and K8 are timed with CUDA events in
   each build and in the default one (which picks per call), beside
   ``scaled_dot_product_attention``, at the main path's shapes (S=577 at
   B=1, 8, 16; S=257 at B=16).  The order is default, 1, 2, SDPA, SDPA, 2,
   1, default, and each time is the mean of its two turns.
2. Rounding point (``--old-checkout DIR``).  For K8 in bf16 at B=1, S=577 on
   the fused projection's views: the fraction of outputs bit-equal to
   ``flash_mha_plain`` (normalised probabilities rounded, as the reference)
   and to the same math with the unnormalised probabilities rounded, with
   the max abs errors, for this checkout's K8 and for the K8 of another
   checkout of the port (its own build and wrapper, run in a subprocess on
   the same inputs): e.g. a commit whose K8 rounded the unnormalised
   probabilities, taken from git history into a git-ignored folder::

       git archive <commit> tstar_tpu_torch | tar -x -C _archive/old
       ... --old-checkout _archive/old

Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from tstar_tpu_torch.kernels import _build, attention

SHAPES = ((1, 577), (8, 577), (16, 577), (16, 257))
HEADS, WIDTH = 12, 768


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call, fenced by CUDA events."""
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


@contextlib.contextmanager
def library(lib):
    """Route the wrappers through ``lib`` inside the block."""
    saved = _build._lib
    _build._lib = lib
    try:
        yield
    finally:
        _build._lib = saved


def pinned_library(wgs: int):
    """Every kernel source built with the attention kernel's warpgroups per
    CTA pinned to ``wgs``."""
    out = _build.BUILD_DIR / f"{_build.library_path().stem}_wgs{wgs}.so"
    if not out.exists():
        _build.compile_library(sorted(_build.CSRC.glob("*.cu")), out, [f"-DTSTAR_ATTN_WGS={wgs}"])
    return _build.open_library(out)


def config(lib, b: int, s: int) -> dict:
    cfg = (ctypes.c_int * 4)()
    _build.check(lib.tstar_attn_config(b, s, HEADS, cfg), "tstar_attn_config")
    return {"warpgroups": cfg[0], "stages": cfg[1], "resident": bool(cfg[2]), "smem_bytes": cfg[3]}


def inputs(b: int, s: int):
    g = torch.Generator(device="cuda").manual_seed(b * s)
    qkv = torch.randn(b, s, 3 * WIDTH, generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = (t.view(b, s, HEADS, 64) for t in qkv.split(WIDTH, dim=-1))
    return qkv, q, k, v


def grid_choice(card: str) -> list:
    libs = {"default": _build.load(), "wgs1": pinned_library(1), "wgs2": pinned_library(2)}
    rows = []
    for b, s in SHAPES:
        qkv, q, k, v = inputs(b, s)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        fns = {
            "K1": lambda: attention.fused_mha_from_qkv(qkv, HEADS),
            "K8": lambda: attention.flash_mha(q, k, v),
        }
        plain = {"K1": attention.fused_mha_from_qkv_plain(qkv, HEADS),
                 "K8": attention.flash_mha_plain(q, k, v)}
        times = {(label, name): [] for label in libs for name in fns}
        sdpa = []
        for label in ("default", "wgs1", "wgs2", "sdpa", "sdpa", "wgs2", "wgs1", "default"):
            if label == "sdpa":
                sdpa.append(cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh)))
                continue
            with library(libs[label]):
                for name, fn in fns.items():
                    times[(label, name)].append(cuda_ms(fn))
        for label, lib in libs.items():
            with library(lib):
                for name, fn in fns.items():
                    err = (fn().float() - plain[name].float()).abs().max().item()
                    ms = sum(times[(label, name)]) / 2
                    row = {"kernel": name, "build": label, "B": b, "S": s, "ms": ms,
                           "sdpa_ms": sum(sdpa) / 2, "max_abs_err": err, **config(lib, b, s)}
                    rows.append(row)
                    print(f"[grid] {name} B={b} S={s} {label}: {ms:.4f} ms (SDPA {row['sdpa_ms']:.4f} ms) "
                          f"warpgroups={row['warpgroups']} stages={row['stages']} "
                          f"resident={row['resident']} smem={row['smem_bytes']} B "
                          f"max_abs_err={err:.3e} ({card})", flush=True)
    return rows


def unnormalised_rounding(q, k, v):
    """``flash_mha_plain`` with the probabilities rounded before the divide
    by the row sum (the rounding point of an online-softmax kernel)."""
    qh, kh, vh = (t.permute(0, 2, 1, 3).float() for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.matmul(p.to(v.dtype).float(), vh) / p.sum(dim=-1, keepdim=True)
    return out.permute(0, 2, 1, 3).to(q.dtype)


# Runs K8 of another checkout (its own build, wrapper and launch counter) on
# the saved inputs, in a process of its own.
_OLD_K8 = """
import sys, torch
from tstar_tpu_torch.kernels.attention import flash_mha
qkv = torch.load(sys.argv[1]).cuda()
q, k, v = (t.view(*qkv.shape[:2], 12, 64) for t in qkv.split(768, dim=-1))
out = flash_mha(q, k, v)
torch.cuda.synchronize()
assert flash_mha.launches == 1
torch.save(out.cpu(), sys.argv[2])
"""


def rounding_point(card: str, old_root: Path) -> dict:
    b, s = 1, 577
    qkv, q, k, v = inputs(b, s)
    refs = {"flash_mha_plain": attention.flash_mha_plain(q, k, v),
            "unnormalised rounding": unnormalised_rounding(q, k, v)}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        torch.save(qkv.cpu(), f"{tmp}/qkv.pt")
        env = {**os.environ, "PYTHONPATH": str(old_root.resolve())}
        subprocess.run([sys.executable, "-c", _OLD_K8, f"{tmp}/qkv.pt", f"{tmp}/out.pt"],
                       cwd=old_root, env=env, check=True, timeout=600)
        got_old = torch.load(f"{tmp}/out.pt").cuda()
    got_new = attention.flash_mha(q, k, v)
    torch.cuda.synchronize()
    result = {"B": b, "S": s}
    for label, got in (("old", got_old), ("new", got_new)):
        result[label] = {}
        for ref_name, want in refs.items():
            equal = (got == want).float().mean().item()
            err = (got.float() - want.float()).abs().max().item()
            result[label][ref_name] = {"bit_equal_fraction": equal, "max_abs_err": err}
            print(f"[rounding] K8 bf16 B={b} S={s} {label} kernel "
                  f"({old_root if label == 'old' else 'this checkout'}) against {ref_name}: "
                  f"bit-equal {equal:.6f}, max abs err {err:.3e} ({card})", flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-checkout", type=Path,
                    help="root of another checkout of the port whose K8 to hold against the plain version")
    ap.add_argument("--out", type=Path, help="write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_bench needs a CUDA device")
    card = card_line()
    print(card, flush=True)
    result = {"card": card, "grid": grid_choice(card)}
    if args.old_checkout:
        result["rounding"] = rounding_point(card, args.old_checkout)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
