"""The mixture-of-experts block of DeepSeek-V3's layout (Kimi-VL's language
model), beside its plain PyTorch versions:

  * ``route``: the sigmoid router in f32, the choice by score plus the
    correction bias (``noaux_tc`` with one group), the chosen scores over
    their sum (+1e-20) times the routed scaling factor; ``moe_route``, its
    CUDA kernel for the decode step (one launch for the plain version's
    eleven), ``route`` on a CPU tensor;
  * ``moe_decode``: the chosen routed experts and the shared experts of 1 to
    4 tokens, a CUDA kernel (``csrc/moe_decode.cu``, two launches) for the
    decode step, ``moe_grouped`` on a CPU tensor;
  * ``moe_grouped``: the same block over any number of tokens (prefill, and
    the decode kernel's plain version): the token-expert pairs sorted by
    expert, one grouped product for every expert's gate|up rows and one for
    the down rows (``torch._grouped_mm``, a library call as the port's other
    large products are), the pairs put back in token order and summed with
    their weights.

None replaces a Pallas kernel: the reference has no MoE model.  Layouts:
``w13`` (E, 2I, D) holds each expert's gate rows then its up rows, ``w2``
(E, D, I) its down rows, ``sw13`` (2 NS I, D) and ``sw2`` (D, NS I) the
NS shared experts as one MLP of width NS I: every weight is stored with the
reduced dimension last, as the kernel reads it.  Every route rounds where
the published block does in bf16: each product to the working dtype, SiLU
in f32 rounded, the weighted sum of a token's experts in f32 rounded, then
the shared experts' output added.

The decode kernel may also count each token-expert pair into ``counts``
(E,) int32 and write the chosen ids into a route log (B, M, K) at the step's
slot, so that a captured step records both with no launch of its own;
on a CPU tensor ``moe_grouped`` counts and one ``index_copy_`` writes the
log.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from tstar_tpu_torch.kernels import _build
from tstar_tpu_torch.kernels.decode import _bf16, _plain_or_raise, silu_mul_plain

MAX_TOKENS = 4          # tokens the decode kernel takes
MAX_TOP_K = 8           # experts a token
MAX_WIDTH = 4096        # the hidden width it takes


def route(x: torch.Tensor, gate: torch.Tensor, bias: torch.Tensor, top_k: int,
          scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, D) hidden states -> (ids (T, K) int64, by score, weights (T, K)
    f32).  ``gate`` (E, D), ``bias`` (E,): both read in f32."""
    scores = torch.sigmoid(torch.matmul(x.float(), gate.float().t()))
    ids = torch.topk(scores + bias.float(), top_k, dim=-1).indices
    w = scores.gather(1, ids)
    return ids, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * scale


def _weighted(y: torch.Tensor, weights: torch.Tensor, shared: torch.Tensor) -> torch.Tensor:
    """(T, K, D) expert outputs -> their f32 weighted sum, rounded, plus the
    shared experts' (T, D)."""
    return (y.float() * weights[..., None]).sum(dim=1).to(shared.dtype) + shared


def shared_experts(x: torch.Tensor, sw13: torch.Tensor, sw2: torch.Tensor) -> torch.Tensor:
    """The shared experts, one SwiGLU MLP: (T, D) -> (T, D)."""
    gu = torch.matmul(x, sw13.t())
    half = gu.shape[-1] // 2
    return torch.matmul(silu_mul_plain(gu[:, :half], gu[:, half:]), sw2.t())


def moe_grouped(x, ids, weights, w13, w2, sw13, sw2, counts=None) -> torch.Tensor:
    """(T, D) hidden states, their chosen ``ids`` / ``weights`` (T, K) ->
    the block's output (T, D), with no host read: the (token, expert) pairs
    sorted by expert, two grouped products over the experts' row ranges,
    the pairs put back in token order.  With ``counts``, each pair is
    counted into it."""
    t, k = ids.shape
    n_experts = w13.shape[0]
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    # counted on the device: ``bincount`` would read the largest id on the host
    per_expert = torch.zeros(n_experts, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    if counts is not None:
        counts += per_expert.to(counts.dtype)
    offs = torch.cumsum(per_expert, 0).to(torch.int32)
    xs = x[order // k]
    i = w2.shape[-1]
    gu = torch._grouped_mm(xs, w13.transpose(1, 2), offs=offs)          # (T K, 2I)
    ys = torch._grouped_mm(silu_mul_plain(gu[:, :i], gu[:, i:]), w2.transpose(1, 2), offs=offs)
    y = torch.empty_like(ys)
    y[order] = ys
    return _weighted(y.view(t, k, -1), weights, shared_experts(x, sw13, sw2))


def moe_decode_supported(x: torch.Tensor, top_k: int, width: int) -> bool:
    """Whether ``moe_decode`` takes the (T, D) tokens ``x``: the plain
    version on the CPU; the kernel for 1 .. 4 bf16 tokens of D <= 4096
    on the card, K <= 8, D and the expert width I multiples of 8."""
    t, d = x.shape
    if not 1 <= t <= MAX_TOKENS:
        return False
    if not x.is_cuda:
        return True
    return (x.dtype == torch.bfloat16 and 1 <= top_k <= MAX_TOP_K and d % 8 == 0
            and d <= MAX_WIDTH and width % 8 == 0)


_TICKETS = {}


def _tickets(device: torch.device) -> torch.Tensor:
    """The router kernel's ticket counters on ``device``: zero once, and
    left zero by every launch (its last CTA resets its token's), so one
    buffer serves every launch and every captured replay (a decode step
    runs eagerly before its capture, which makes it)."""
    t = _TICKETS.get(device)
    if t is None:
        t = _TICKETS[device] = torch.zeros(MAX_TOKENS, dtype=torch.int32, device=device)
    return t


def moe_route(x: torch.Tensor, gate: torch.Tensor, bias: torch.Tensor, top_k: int,
              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``route`` on a CPU tensor; on a CUDA tensor one launch (bf16 x of
    D <= 4096, a multiple of 8; a bf16 (E, D) gate and bias, E <= 256,
    K <= 8), or raise.  The kernel's dot products run in another order than
    the plain product's, so a choice between two scores within an f32 ulp
    may part."""
    if _plain_or_raise(x, "moe_route"):
        return route(x, gate, bias, top_k, scale)
    t, d = x.shape
    n_experts, dev = gate.shape[0], x.get_device()
    if (t > MAX_TOKENS or d % 8 or d > MAX_WIDTH or n_experts > 256
            or not 1 <= top_k <= min(MAX_TOP_K, n_experts)):
        raise ValueError(f"moe_route kernel does not take D = {d}, E = {n_experts}, K = {top_k}")
    ids = torch.empty(t, top_k, dtype=torch.int64, device=x.device)
    weights = torch.empty(t, top_k, dtype=torch.float32, device=x.device)
    scratch = torch.empty(t, 2 * n_experts, dtype=torch.float32, device=x.device)
    status = _build.call(
        _build.load().tstar_moe_route, dev, _bf16("x", x, dev), _bf16("gate", gate, dev, (n_experts, d)),
        _bf16("bias", bias, dev, (n_experts,)), ids.data_ptr(), weights.data_ptr(),
        scratch.data_ptr(), _tickets(x.device).data_ptr(), t, d, n_experts, top_k,
        ctypes.c_float(scale))
    _build.check(status, "tstar_moe_route")
    moe_route.launches += 1
    return ids, weights


def moe_decode(x, ids, weights, w13, w2, sw13, sw2, counts=None, route_log=None,
               index=None) -> torch.Tensor:
    """The block of ``moe_grouped`` for 1 .. 4 tokens, the chosen ids also
    written into ``route_log`` (T, M, K) at slot ``index``: on a CPU tensor
    ``moe_grouped`` and one ``index_copy_``; on a CUDA tensor the kernel's
    two launches (``moe_decode_supported``), or raise."""
    if _plain_or_raise(x, "moe_decode"):
        out = moe_grouped(x, ids, weights, w13, w2, sw13, sw2, counts)
        if route_log is not None:
            route_log.index_copy_(1, torch.as_tensor(index, device=ids.device).view(1),
                                  ids[:, None])
        return out
    t, d = x.shape
    k = ids.shape[1]
    n_experts, two_i = w13.shape[:2]
    i = two_i // 2
    n_shared = sw2.shape[1] // i
    dev = x.get_device()
    if not moe_decode_supported(x, k, i):
        raise ValueError(f"moe_decode kernel does not take {t} tokens of {d} ({x.dtype}), "
                         f"K = {k}, I = {i}")
    if ids.dtype != torch.int64 or tuple(ids.shape) != (t, k) or not ids.is_contiguous():
        raise ValueError(f"ids must be int64 ({t}, {k}), contiguous")
    if weights.dtype != torch.float32 or tuple(weights.shape) != (t, k) or not weights.is_contiguous():
        raise ValueError(f"weights must be f32 ({t}, {k}), contiguous")
    ptrs = [_bf16("x", x, dev), ids.data_ptr(), weights.data_ptr(),
            _bf16("w13", w13, dev, (n_experts, 2 * i, d)), _bf16("w2", w2, dev, (n_experts, d, i)),
            _bf16("sw13", sw13, dev, (2 * n_shared * i, d)),
            _bf16("sw2", sw2, dev, (d, n_shared * i))]
    act = torch.empty(t, k + n_shared, i, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    m = 0
    if counts is not None and (counts.dtype != torch.int32 or tuple(counts.shape) != (n_experts,)
                               or not counts.is_contiguous()):
        raise ValueError(f"counts must be int32 ({n_experts},), contiguous")
    if route_log is not None:
        m = route_log.shape[1]
        if (route_log.dtype != torch.int64 or tuple(route_log.shape) != (t, m, k)
                or not route_log.is_contiguous()):
            raise ValueError(f"route_log must be int64 ({t}, M, {k}), contiguous")
        if not torch.is_tensor(index):
            index = torch.tensor(index, dtype=torch.int64, device=x.device)
        if index.dtype != torch.int64 or index.numel() != 1:
            raise ValueError("index must be one int64 value")
    status = _build.call(
        _build.load().tstar_moe_decode, dev, *ptrs, act.data_ptr(), out.data_ptr(),
        None if counts is None else counts.data_ptr(),
        None if route_log is None else route_log.data_ptr(),
        None if route_log is None else index.data_ptr(), t, k, n_shared, d, i, m)
    _build.check(status, "tstar_moe_decode")
    moe_decode.launches += 1
    return out


moe_route.launches = 0          # kernel launches
moe_decode.launches = 0         # calls that launched the kernel (two launches each)
