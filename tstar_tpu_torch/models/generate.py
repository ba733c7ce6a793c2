"""Autoregressive generation for the port's VLMs (port of ``tstar_tpu/models/generate.py``).

Two phases, as in the reference: one PREFILL over the right-padded prompts
fills a static cache that the model makes (``model.init_cache``: Qwen2's
(B, max_len, kv_heads, head_dim) K and V per layer, Kimi-VL's latent cache
of 576 values a slot and layer), then a DECODE loop emits up to
``max_new_tokens`` tokens with a per-sequence done mask (a sequence that
emitted an end token keeps emitting ``eos[0]``).
Temperature 0 takes the argmax; otherwise a token is drawn from
softmax(logits / temperature) as the argmax of logits / temperature plus
Gumbel noise from an explicit ``torch.Generator`` (``jax.random.categorical``
draws the same way, from another key schedule, so sampled tokens differ
from the reference's).

The decode step reads its cache slot, positions (made by the model from
each sequence's next one: ``model.step_positions``), token and done mask
from static device buffers of its (B, max_len) bucket and writes the cache
in place.  On a CUDA device (``graphs=None`` or True) the step is captured
once into a CUDA graph per (model, B, max_len, greedy, end tokens, cache
dtype) and replayed (``utils/cuda_graphs.StepGraphs``): the counterpart of
the reference's single ``lax.while_loop``.  A second request of the same
bucket captures nothing.  A sampling bucket draws from a generator of its
own, registered with its graph: the caller's generator state is copied
in before the loop and back after it.  max_len rounds the prompt plus the
new tokens up to a multiple of 128 so that requests share buckets; the
extra slots are masked and add exact zeros.  A model keeps its
``MAX_BUCKETS`` most recently used buckets (each holds a KV cache and a
graph) and frees the others.  A capture that fails raises
``GraphCaptureError``: there is no fallback.

Under tensor parallelism (``parallel/shardings.shard_module``) the KV cache
holds this rank's kv heads, and a sampled token is broadcast from the
model group's first rank, so every rank of the group emits the same tokens
(the logits are all-gathered, so a greedy pick agrees by itself).  NCCL's
collectives are captured with the step; a model sharded over a gloo group
of several ranks decodes eagerly (``GenerateStats.eager_reason`` says why,
and ``graphs=True`` raises there).

The KV cache takes the model's dtype unless ``cache_dtype`` says otherwise.
The reference's defaults to bf16 whatever the model's dtype, which is the
same for its bf16 default and fails on an f32 model (its cache write
refuses the mixed dtypes).

The model chooses the kernels its step runs on the card; the loop names
none.  ``GenerateStats.step_launches`` holds each kernel wrapper's launches
in one step (the bucket's first, eager step), and a replay adds the
launches its capture recorded to the wrappers' counts.

The loop reads the host once a step: whether every sequence is done, as one
small non-blocking copy into pinned memory, awaited on an event.  Step t+1
is enqueued before the host waits for step t's flag, so the card never
waits for the host; the one step that may run after the last sequence
finished only writes ``eos[0]``, which the output already holds there.
``graphs=False`` runs the same step eagerly on the card; the CPU always
runs it eagerly.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tstar_tpu_torch.models.tensor_parallel import broadcast_first_, graph_blocker, tensor_parallel
from tstar_tpu_torch.utils.cuda_graphs import StepGraphs, use_graphs
from tstar_tpu_torch.utils.profiling import trace

BUCKET = 128
MAX_BUCKETS = 4


@dataclasses.dataclass
class GenerateStats:
    """What ``generate`` did, filled in when passed as ``stats=``.  With
    ``timed``, each request's prefill and decode device milliseconds: the
    CUDA events of its ``generate.prefill`` and ``generate.decode`` spans
    (``utils/profiling.trace``), recorded with or without a profiler and
    read after the request's last step, outside the loop."""

    timed: bool = False
    decode_steps: int = 0       # steps enqueued (one may follow the last token)
    captures: int = 0
    replays: int = 0
    flag_reads: int = 0         # host reads in the loop (one a step)
    prefill_ms: List[float] = dataclasses.field(default_factory=list)
    decode_ms: List[float] = dataclasses.field(default_factory=list)
    eager_reason: str = ""      # why a CUDA device decoded without graphs
    # each kernel wrapper's launches in one decode step, by its
    # ``kernels.launch_counts`` name (none on the CPU)
    step_launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def moe_layers(self) -> int:
        """The step's MoE layers on ``kernels/moe.moe_decode``."""
        return self.step_launches.get("moe_decode", 0)


def bucket_len(n: int) -> int:
    return -(-n // BUCKET) * BUCKET


def prefill(model, input_ids, prompt_lens, position_ids, image_patches, image_grid_hw,
            max_len: int, cache_dtype=None, caches=None):
    """-> (next-token logits (B, vocab) f32, caches filled to ``prompt_lens``).

    ``caches`` (as ``model.init_cache`` makes them) are written in place;
    new zero caches when None."""
    b, s = input_ids.shape
    dev = input_ids.device
    if caches is None:
        caches = model.init_cache(b, max_len, cache_dtype or model.dtype, dev)
    image_embeds = None
    if image_patches is not None:
        enc = model.encode_images(image_patches, image_grid_hw)
        image_embeds = enc.reshape(-1, enc.shape[-1])
    hidden = model.embed(input_ids, image_embeds)
    # keys live in the cache (max_len slots); the prefill sees the causal
    # prompt prefix
    col = torch.arange(max_len, device=dev)
    causal = (col[None, :] <= torch.arange(s, device=dev)[:, None])[None, None]
    key_valid = (col[None] < prompt_lens[:, None])[:, None, None, :]
    bias = torch.where(causal & key_valid, 0.0, torch.finfo(torch.float32).min)
    hidden, caches = model.decoder(hidden, position_ids, bias, caches, 0)
    last = hidden[torch.arange(b, device=dev), prompt_lens.long() - 1]
    return model.logits(last[:, None])[:, 0], caches


def _sample(logits: torch.Tensor, greedy: bool, temperature, generator, tp=None) -> torch.Tensor:
    """The next tokens; a sampled pick is the model group's first rank's
    (``tp``: the model's ``TensorParallel``)."""
    if greedy:
        return logits.argmax(dim=-1)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return broadcast_first_((logits / temperature + gumbel).argmax(dim=-1), tp)


def decode_step(model, token, index, next_pos, key_valid, caches):
    """One-token decoder forward -> logits (B, vocab); this step's K/V are
    written into ``caches`` at slot ``index`` in place."""
    hidden = model.embed(token[:, None], None)
    pos = model.step_positions(next_pos)
    max_len = key_valid.shape[1]
    ok = key_valid & (torch.arange(max_len, device=token.device)[None] <= index)
    bias = torch.where(ok[:, None, None, :], 0.0, torch.finfo(torch.float32).min)
    hidden, _ = model.decoder(hidden, pos, bias, caches, index)
    return model.logits(hidden)[:, 0]


class DecodeBucket:
    """Static buffers of one (B, max_len) decode loop, and its CUDA graph."""

    def __init__(self, model, b: int, max_len: int, n_eos: int, greedy: bool,
                 cache_dtype, graphs: bool):
        dev = model.device
        self.model = model
        self.greedy = greedy
        self.generator = None if greedy else torch.Generator(device=dev)
        self.graphs = StepGraphs(dev, graphs, "decode")
        self.tp = tensor_parallel(model)
        self.caches = model.init_cache(b, max_len, cache_dtype, dev)
        i64 = dict(dtype=torch.int64, device=dev)
        self.token = torch.zeros(b, **i64)
        self.next_pos = torch.zeros(b, **i64)
        self.step = torch.zeros((), **i64)
        self.start = torch.zeros((), **i64)
        self.done = torch.zeros(b, dtype=torch.bool, device=dev)
        self.flag = torch.zeros((), dtype=torch.bool, device=dev)
        self.out = torch.zeros(b, max_len, **i64)
        self.key_valid = torch.zeros(b, max_len, dtype=torch.bool, device=dev)
        self.eos = torch.zeros(n_eos, **i64)
        self.temperature = torch.ones((), dtype=torch.float32, device=dev)
        if dev.type == "cuda":
            self._pinned = torch.zeros(2, dtype=torch.bool).pin_memory()
            self._events = [torch.cuda.Event(), torch.cuda.Event()]
        self._host_flags: Dict[int, bool] = {}

    def body(self) -> None:
        """One decode step on the static buffers (no host read)."""
        index = self.start + self.step - 1
        logits = decode_step(self.model, self.token, index, self.next_pos, self.key_valid,
                             self.caches)
        new = _sample(logits, self.greedy, self.temperature, self.generator, self.tp)
        new = torch.where(self.done, self.eos[0], new)
        self.done |= (new[:, None] == self.eos[None]).any(dim=-1)
        self.out.index_copy_(1, self.step.view(1), new[:, None])
        self.token.copy_(new)
        self.next_pos += 1
        self.step += 1
        self.flag.copy_(self.done.all())

    def run_step(self, stats: GenerateStats) -> None:
        """Enqueue one step: replay the graph, or run the body eagerly (and,
        with graphs, capture it after its first eager run)."""
        stats.decode_steps += 1
        self.graphs.run("step", self.body, stats,
                        generators=() if self.generator is None else (self.generator,))
        stats.step_launches = dict(self.graphs.launches["step"])

    def start_flag_read(self, t: int) -> None:
        """Start the read of step t's flag (CPU: read it now)."""
        if self.model.device.type != "cuda":
            self._host_flags[t] = bool(self.flag)
            return
        self._pinned[t % 2].copy_(self.flag, non_blocking=True)
        self._events[t % 2].record()

    def wait_flag(self, t: int, stats: GenerateStats) -> bool:
        """Step t's flag: the loop's one host read a step."""
        stats.flag_reads += 1
        if self.model.device.type != "cuda":
            return self._host_flags.pop(t)
        self._events[t % 2].synchronize()
        return bool(self._pinned[t % 2])

    def decode(self, token0, done0, next_pos0, start: int, base_valid, eos, temperature,
               generator, max_new_tokens: int, stats: GenerateStats) -> torch.Tensor:
        """The decode loop from the prefill's first token -> (B, max_new);
        sampling draws from ``generator``'s state, which it advances."""
        if self.generator is not None:
            self.generator.set_state(generator.get_state())
        self.token.copy_(token0)
        self.done.copy_(done0)
        self.next_pos.copy_(next_pos0)
        self.start.fill_(start)
        self.step.fill_(1)
        self.key_valid.copy_(base_valid)
        self.eos.copy_(eos)
        self.temperature.fill_(max(temperature, 1e-6))
        self.out.copy_(eos[0].expand_as(self.out))
        self.out[:, 0] = token0
        self._host_flags.clear()
        t = 1
        self.run_step(stats)
        self.start_flag_read(t)
        while t + 1 < max_new_tokens:
            self.run_step(stats)                 # step t + 1 before the wait for t
            self.start_flag_read(t + 1)
            if self.wait_flag(t, stats):
                break
            t += 1
        if self.generator is not None:
            generator.set_state(self.generator.get_state())
        return self.out[:, :max_new_tokens].clone()      # the buffer serves the next request


def _bucket(model, key: Tuple, make) -> DecodeBucket:
    """The model's bucket for ``key`` (made by ``make()`` if it has none),
    now its most recently used; the least recently used beyond
    ``MAX_BUCKETS`` are dropped, with their caches and graphs."""
    buckets = getattr(model, "_decode_buckets", None)
    if buckets is None:
        buckets = model._decode_buckets = collections.OrderedDict()
    bucket = buckets.pop(key, None) or make()
    buckets[key] = bucket
    while len(buckets) > MAX_BUCKETS:
        buckets.popitem(last=False)
    return bucket


def generate(
    model,
    input_ids,                   # (B, S) right-padded int
    prompt_lens,                 # (B,)
    position_ids,                # (3, B, S) M-RoPE, or the model's own, e.g. (B, S)
    max_new_tokens: int,
    eos_token_ids: Sequence[int],
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    image_patches=None,
    image_grid_hw: Optional[Tuple[int, int]] = None,
    cache_dtype: Optional[torch.dtype] = None,
    graphs: Optional[bool] = None,
    stats: Optional[GenerateStats] = None,
) -> torch.Tensor:
    """-> generated tokens (B, max_new_tokens) int64 on the model's device,
    ``eos[0]``-padded after a sequence's end token.  Inputs may be numpy or
    tensors: they are uploaded once.  ``cache_dtype`` defaults to the
    model's dtype."""
    dev = model.device
    stats = stats if stats is not None else GenerateStats()
    def upload(x, dtype=None):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        return t.to(dev, dtype)

    input_ids = upload(input_ids, torch.int64)
    prompt_lens = upload(prompt_lens, torch.int64)
    position_ids = upload(position_ids, torch.int64)
    if image_patches is not None:
        image_patches = upload(image_patches)
    b, s_pad = input_ids.shape
    max_len = bucket_len(s_pad + max_new_tokens)
    greedy = temperature <= 0.0
    if generator is None and not greedy:
        generator = torch.Generator(device=dev).manual_seed(0)
    eos = torch.as_tensor(list(eos_token_ids), dtype=torch.int64).to(dev)
    cache_dtype = cache_dtype or model.dtype
    graphed = use_graphs(graphs, dev, graph_blocker(model), stats)

    bucket = None
    if max_new_tokens > 1:
        bucket = _bucket(model, (b, max_len, greedy, len(eos), cache_dtype, graphed),
                         lambda: DecodeBucket(model, b, max_len, len(eos), greedy, cache_dtype,
                                              graphed))
    caches = bucket.caches if bucket is not None else None
    timed = stats.timed and dev.type == "cuda"
    with trace("generate.prefill", device=dev, timed=timed) as prefill_span:
        logits, caches = prefill(model, input_ids, prompt_lens, position_ids, image_patches,
                                 image_grid_hw, max_len, cache_dtype, caches)
        # text positions continue from max(prompt positions) + 1 per sequence
        # (over M-RoPE's three rows too)
        seq_mask = torch.arange(s_pad, device=dev)[None] < prompt_lens[:, None]
        masked = torch.where(seq_mask, position_ids, torch.full_like(position_ids, -1))
        next_pos = masked.reshape(-1, b, s_pad).amax(dim=(0, 2)) + 1
        token0 = _sample(logits, greedy, max(temperature, 1e-6), generator,
                         tensor_parallel(model))
    if max_new_tokens == 1:
        return token0[:, None]
    with trace("generate.decode", device=dev, timed=timed) as decode_span:
        done0 = (token0[:, None] == eos[None]).any(dim=-1)
        # cache slots holding real keys: the true prompt prefix and every
        # decode slot (decode writes start at s_pad; padded prompt slots stay
        # masked)
        slots = torch.arange(max_len, device=dev)[None]
        base_valid = (slots < prompt_lens[:, None]) | (slots >= s_pad)
        out = bucket.decode(token0, done0, next_pos, s_pad, base_valid, eos, temperature,
                            generator, max_new_tokens, stats)
    if timed:
        stats.prefill_ms.append(prefill_span.device_ms())
        stats.decode_ms.append(decode_span.device_ms())
    return out
