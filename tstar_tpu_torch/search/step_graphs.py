"""Search steps over static buffers, replayed as CUDA graphs on the card: the
port's counterpart of the reference's ``jax.jit`` of a step.

A step of B videos (B = 1 for the single-video search) is three phases, each
a function of static device buffers:

  (a) noise -> sample -> grid forward -> splat -> smoother -> candidate
      partition and count;
  (b) one verification round of the bucket width: the round index lives in
      device memory and the round's start is clamped as ``lax.dynamic_slice``
      clamps it; replayed once per round.  The wide rescore (every sampled
      frame in one forward) is its own graph;
  (c) replay of the removals -> commit (rows of finished videos keep their
      state) -> loop flags.

The host reads the device twice a step: the candidate count after (a), which
sets the rounds of (b), and the flags after (c), which end the loop.  Each
read is one small non-blocking copy into pinned memory, awaited on an event.

A streaming search (``paged=``, a ``video/cache.StreamingFrameCache``)
splits (a) at the sampled seconds: (a1) noise -> sample into the static
``secs``; the host reads the K seconds, decodes their frames
(``paged.gather_host``) and copies them through a pinned staging buffer
into the scorer's static step buffer; (a2) grid forward -> splat ->
smoother -> candidates.  That makes three host reads a step, and the same
trajectory as the resident search over the same frames.

With graphs (the default on a CUDA device) each phase's first use runs
eagerly and is then captured into a CUDA graph that every later use of the
run replays (``utils/cuda_graphs.StepGraphs``, one memory pool a stepper).
A capture that fails raises ``GraphCaptureError``; the run never falls
back to eager phases.  Iteration 0 samples by stride and draws no noise,
so it always runs eagerly.  Each video's noise generator is registered
with the graphs of (a) and (a1), so a replay draws what the eager phase
would: a replay of (a) draws for every video, so the generator of a video
that has finished is saved when it finishes and put back before the final
pop.

On the CPU, or with ``graphs=False``, the same phase functions run eagerly
every time, and noise is drawn only for videos still searching.

A detector sharded for tensor parallelism (``parallel/shardings.py``) holds
collectives in its forward.  NCCL's are captured with the phases.  Over a
gloo model group of several ranks the steps run eagerly: the choice is made
from the scorer's model when the stepper is built, logged and kept in
``StepStats.eager_reason`` (``graphs=True`` raises there).  The ranks of a
model group step the same videos: every host read is checked against the
group's (``models/tensor_parallel.agree``) before the value steers the next
collectives, so ranks that part raise instead of waiting for each other.

History mode (``history=True``, the drivers behind the reference's
``run_search_with_history`` and ``run_search_batched_with_history``) keeps
what each step did for the visualization sinks: phase (a) scores the grid
through the scorer's detailed method where it has one
(``score_grid_detailed`` / ``score_grid_batch_detailed``), which computes the
same confidences and also writes the grid image's detections into static
buffers; phase (c) copies the step's snapshot (active mask, sampled seconds,
grid confidences, the committed ``P`` / ``scores`` / ``visited`` and the
detections) device to device into ``(cap, ...)`` buffers at the row of a
step counter kept on the device.  ``cap`` is the most steps the budgets
allow (``ceil(budget / K)``, read with the setup read).  The buffers are read
once, after the loop, so a history search makes the same two host reads a
step as one without.

Spans (``utils/profiling.trace``, recorded only under a profiler):
``search.step`` around a step, ``search.read`` around each read's wait,
``search.setup`` around the setup read, ``search.capture`` around a phase's
first use (its eager run and capture), ``search.history`` around
``history_rows``; and, timed on the device, ``search.phase.a`` (a, or a1
and a2), ``search.phase.verify`` (the rounds or the wide rescore) and
``search.phase.c``, each around the phase's run from outside, since no
event may be recorded inside a capture.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tstar_tpu_torch.ops.sampling import draw_gumbel
from tstar_tpu_torch.models.tensor_parallel import agree, graph_blocker, tensor_parallel
from tstar_tpu_torch.search.engine import apply_grid_scores, replay_verification, sample_secs
from tstar_tpu_torch.search.state import BatchedState, SearchState
from tstar_tpu_torch.utils.config import SearchConfig
from tstar_tpu_torch.utils.cuda_graphs import StepGraphs, use_graphs
from tstar_tpu_torch.utils.profiling import trace


@dataclasses.dataclass
class StepStats:
    """What a driver did, filled in when passed as ``stats=``.  With
    ``record`` each step's active videos, sampled seconds and grid
    confidences are kept, with what the seconds were sampled from (the
    distribution, the visited seconds, the noise, the valid count): device
    tensors, read by the caller afterwards."""

    record: bool = False
    steps: int = 0
    grid_images: int = 0
    verify_widths: List[int] = dataclasses.field(default_factory=list)
    replays: int = 0
    captures: int = 0
    host_reads: int = 0          # reads inside steps (two a step, three streaming)
    setup_reads: int = 0         # the read before the first step
    stream_seconds: float = 0.0  # streaming: host decode + upload of the step frames
    eager_reason: str = ""       # why a CUDA device stepped without graphs
    trace: List[Dict[str, Any]] = dataclasses.field(default_factory=list)


class Stepper:
    """Static buffers of one search run over B videos and its three phases.

    ``mode``: 'single' (one video, the scorer's single-video methods and the
    adaptive wide rescore), 'flat' (one candidate list over all videos,
    ``score_verify_flat``), or 'per_video' (per-video buckets,
    ``score_verify_batch``).  ``paged``: a streaming cache (single mode).
    ``verify=False``: no verification in the step (no count read, no
    rounds, phase (c) commits the grid's scores); the caller verifies
    between steps (``search/reference_verify.py``).
    """

    def __init__(self, *, scores, visited, P, remaining, budget, n_valid, iteration,
                 rngs, scorer, config: SearchConfig, mode: str, graphs: Optional[bool],
                 stats: Optional[StepStats] = None, history: bool = False, paged=None,
                 verify: bool = True):
        self.dev = scores.device
        self.verify = verify
        self.config, self.scorer, self.mode = config, scorer, mode
        self.history = history
        detailed = "score_grid_detailed" if mode == "single" else "score_grid_batch_detailed"
        self.detailed = history and hasattr(scorer, detailed)
        self.rngs = list(rngs)
        self.stats = stats if stats is not None else StepStats()
        model = getattr(scorer, "model", None)
        enabled = use_graphs(graphs, self.dev, graph_blocker(model), self.stats)
        tp = tensor_parallel(model)
        self.model_tp = tp if tp is not None and tp.size > 1 else None
        b, n = scores.shape
        t_max, k = remaining.shape[-1], config.frames_per_iteration
        self.b, self.n, self.k, self.t_max = b, n, k, t_max
        self.width = min(config.verify_batch or k, k)
        dev = self.dev
        self.scores, self.visited, self.P = scores.clone(), visited.clone(), P.clone()
        self.remaining = remaining.clone()
        self.budget, self.iteration = budget.clone(), iteration.clone()
        self.n_valid = n_valid.clone()
        self.valid = torch.arange(n, device=dev) < self.n_valid[:, None]
        # step buffers, written by (a) and (b), read by (b) and (c)
        self.gumbel = torch.zeros(b, n, dtype=torch.float32, device=dev)
        self.secs = torch.zeros(b, k, dtype=torch.int64, device=dev)
        self.conf = torch.zeros(b, k, dtype=torch.float32, device=dev)
        self.tp = torch.zeros(b, k, t_max, dtype=torch.bool, device=dev)
        self.new_scores, self.new_visited, self.new_P = (
            torch.zeros_like(self.scores), torch.zeros_like(self.visited), torch.zeros_like(self.P)
        )
        self.active = torch.zeros(b, dtype=torch.bool, device=dev)
        self.order = torch.zeros(*((b, k) if mode == "per_video" else (b * k,)),
                                 dtype=torch.int64, device=dev)
        self.n_cand = torch.zeros((), dtype=torch.int64, device=dev)
        self.vconf = torch.zeros(b * k, dtype=torch.float32, device=dev)
        self.vpres = torch.zeros(b * k, t_max, dtype=torch.bool, device=dev)
        self.round = torch.zeros((), dtype=torch.int64, device=dev)
        self.round_rows = torch.arange(self.width, device=dev)
        self.flags = torch.zeros(b, dtype=torch.bool, device=dev)
        self.paged = paged
        if paged is not None:
            if mode != "single":
                raise ValueError("a streaming search steps one video")
            if not hasattr(scorer, "step_frames"):
                raise TypeError(
                    f"{type(scorer).__name__} does not support streaming caches (needs "
                    "step_frames/step_secs fields; use a detector scorer, or "
                    "cache_mode='resident'/'downscale' for table scorers)"
                )
            self.scorer = scorer = dataclasses.replace(
                scorer,
                step_frames=torch.zeros((k, *paged.cache_hw, 3), dtype=torch.uint8, device=dev),
                step_secs=torch.zeros(k, dtype=torch.int64, device=dev),
            )
        # history mode: the step counter, the detections of the step's grid
        # forward and the (cap, ...) history rows, allocated by the first
        # phase (a) and (c), which run eagerly
        self.hstep = torch.zeros((), dtype=torch.int64, device=dev)
        self.dets: Optional[Dict[str, torch.Tensor]] = None
        self.hist: Dict[str, torch.Tensor] = {}
        self.graphs = StepGraphs(dev, enabled, "step phase", span="search.capture")
        if enabled:
            gens = [g for g in self.rngs if isinstance(g, torch.Generator)]
            if len(gens) != b or len({id(g) for g in gens}) != b:
                raise ValueError("graph stepping needs one distinct torch.Generator per video")
        if self.dev.type == "cuda":
            self._pinned = {
                "count": torch.empty((), dtype=torch.int64, pin_memory=True),
                "flags": torch.empty(b, dtype=torch.bool, pin_memory=True),
                "setup": torch.empty(3 * b, dtype=torch.int64, pin_memory=True),
                "secs": torch.empty(b, k, dtype=torch.int64, pin_memory=True),
            }
            if paged is not None:
                self._staging = torch.empty(tuple(self.scorer.step_frames.shape),
                                            dtype=torch.uint8, pin_memory=True)
            self._event = torch.cuda.Event()

    # -- construction ---------------------------------------------------------
    @classmethod
    def single(cls, state: SearchState, scorer, config, graphs=None, stats=None,
               history=False, paged=None, verify=True) -> "Stepper":
        dev = state.scores.device

        def one(v):
            return torch.full((1,), int(v), dtype=torch.int64, device=dev)

        return cls(scores=state.scores[None], visited=state.visited[None], P=state.P[None],
                   remaining=state.remaining[None], budget=one(state.budget),
                   n_valid=one(state.n_valid), iteration=one(state.iteration), rngs=[state.rng],
                   scorer=scorer, config=config, mode="single", graphs=graphs, stats=stats,
                   history=history, paged=paged, verify=verify)

    @classmethod
    def batched(cls, states: BatchedState, scorer, config, graphs=None, stats=None,
                history=False) -> "Stepper":
        mode = "per_video" if config.verify_flat is False else "flat"
        return cls(scores=states.scores, visited=states.visited, P=states.P,
                   remaining=states.remaining, budget=states.budget, n_valid=states.n_valid,
                   iteration=states.iteration, rngs=states.rngs, scorer=scorer, config=config,
                   mode=mode, graphs=graphs, stats=stats, history=history)

    def single_state(self, state: SearchState, steps: int) -> SearchState:
        """The run's final single-video state (the host keeps budget and
        iteration: a single search steps only while it is active)."""
        return state.replace(
            scores=self.scores[0].clone(), visited=self.visited[0].clone(), P=self.P[0].clone(),
            remaining=self.remaining[0].clone(),
            budget=state.budget - steps * self.k, iteration=state.iteration + steps,
        )

    def batched_state(self) -> BatchedState:
        return BatchedState(
            scores=self.scores.clone(), visited=self.visited.clone(), P=self.P.clone(),
            remaining=self.remaining.clone(), budget=self.budget.clone(),
            n_valid=self.n_valid.clone(), iteration=self.iteration.clone(), rngs=self.rngs,
        )

    # -- the scorer, as the mode calls it -------------------------------------
    def _grid(self, secs):
        """-> (conf (B, K), presence (B, K, C), detections with a leading B
        axis or None)."""
        if self.mode == "single":
            if self.detailed:
                conf, presence, dets = self.scorer.score_grid_detailed(secs[0])
                return conf[None], presence[None], {k: v[None] for k, v in dets.items()}
            conf, presence = self.scorer.score_grid(secs[0])
            return conf[None], presence[None], None
        if self.detailed:
            return self.scorer.score_grid_batch_detailed(secs)
        return (*self.scorer.score_grid_batch(secs), None)

    def _verify_flat(self, video_idx, secs):
        if self.mode == "single":
            return self.scorer.score_verify(secs)
        return self.scorer.score_verify_flat(video_idx, secs)

    def _verify_wide(self, secs):
        if self.mode == "single":
            conf, presence = self.scorer.score_verify(secs[0])
            return conf[None], presence[None]
        return self.scorer.score_verify_batch(secs)

    # -- phases ---------------------------------------------------------------
    def _phase_a(self, first: Optional[torch.Tensor], draw: List[bool]) -> None:
        """Noise (videos in ``draw``), sample, grid forward, splat, smoother,
        candidates.  ``first``: (B,) bool of rows at iteration 0, or None."""
        self._phase_a1(first, draw)
        self._phase_a2()

    def _phase_a1(self, first: Optional[torch.Tensor], draw: List[bool]) -> None:
        """Noise and sampling into the static ``secs`` and ``active``."""
        for i, d in enumerate(draw):
            if d:
                self.gumbel[i].copy_(draw_gumbel(self.rngs[i], self.n, self.dev))
        self.active.copy_(self.remaining.any(dim=-1) & (self.budget > 0))
        all_first = first is not None and not any(draw)
        self.secs.copy_(sample_secs(self.P, self.visited, self.valid, self.n_valid,
                                    None if all_first else self.gumbel, first, self.config))

    def _phase_a2(self) -> None:
        """Grid forward on the sampled ``secs``, splat, smoother,
        candidates."""
        cfg, secs, active = self.config, self.secs, self.active
        if self.paged is not None:
            self.scorer.step_secs.copy_(secs[0])
        conf, presence, dets = self._grid(secs)
        if dets is not None:
            if self.dets is None:
                self.dets = {k: torch.zeros_like(v) for k, v in dets.items()}
            for k, v in dets.items():
                self.dets[k].copy_(v)
        scores, visited, p = apply_grid_scores(
            self.scores, self.visited, self.valid, self.n_valid, secs, conf, cfg
        )
        tp = presence[..., :self.t_max]
        # finished videos' rows are rescored by no forward (their step is discarded)
        cand = (tp & self.remaining[:, None, :]).any(dim=-1) & active[:, None]
        if self.mode == "per_video":
            # stable partition per video: candidate frames first, in order
            order = torch.argsort((~cand).to(torch.int32), dim=1, stable=True)
            count = cand.sum(dim=1).max()
        else:
            order = torch.argsort((~cand).reshape(-1).to(torch.int32), stable=True)
            count = cand.sum()
        for buf, val in ((self.conf, conf.to(torch.float32)), (self.tp, tp),
                         (self.new_scores, scores), (self.new_visited, visited),
                         (self.new_P, p), (self.order, order), (self.n_cand, count)):
            buf.copy_(val)
        self.vconf.zero_()
        self.vpres.zero_()
        self.round.zero_()

    def _fetch_frames(self) -> None:
        """Streaming: read the sampled seconds, decode their frames on the
        host and copy them into the scorer's step buffer (through pinned
        memory on a CUDA device)."""
        secs = self._read(self.secs, "secs")
        self.stats.host_reads += 1
        t0 = time.perf_counter()
        frames = torch.from_numpy(np.ascontiguousarray(self.paged.gather_host(secs)))
        if self.dev.type == "cuda":
            self._staging.copy_(frames)
            self.scorer.step_frames.copy_(self._staging, non_blocking=True)
        else:
            self.scorer.step_frames.copy_(frames)
        self.stats.stream_seconds += time.perf_counter() - t0

    def _phase_round(self) -> None:
        """One verification round of ``width`` candidates; the last round's
        start clamps, and its extra rows land on frames the replay never
        reads."""
        t, k = self.width, self.k
        if self.mode == "per_video":
            start = torch.clamp(self.round * t, max=k - t)
            idx = self.order.index_select(1, start + self.round_rows)        # (B, t)
            conf, presence = self.scorer.score_verify_batch(self.secs.gather(1, idx))
            self.vconf.view(self.b, k).scatter_(1, idx, conf.to(torch.float32))
            self.vpres.view(self.b, k, self.t_max).scatter_(
                1, idx[..., None].expand(-1, -1, self.t_max), presence[..., :self.t_max]
            )
        else:
            start = torch.clamp(self.round * t, max=self.order.numel() - t)
            idx = self.order[start + self.round_rows]                        # (t,)
            conf, presence = self._verify_flat(
                torch.div(idx, k, rounding_mode="floor"), self.secs.reshape(-1)[idx]
            )
            self.vconf[idx] = conf.to(torch.float32)
            self.vpres[idx] = presence[:, :self.t_max]
        self.round += 1

    def _phase_wide(self) -> None:
        """Every sampled frame rescored in one forward."""
        conf, presence = self._verify_wide(self.secs)
        self.vconf.copy_(conf.reshape(-1))
        self.vpres.copy_(presence[..., :self.t_max].reshape(-1, self.t_max))

    def _phase_c(self) -> None:
        """Replay the removals (unless the caller verifies, ``verify=False``),
        commit active rows, set the loop flags."""
        b, k, t = self.b, self.k, self.t_max
        scores, remaining = self.new_scores, self.remaining
        if self.verify:
            scores, remaining = replay_verification(
                scores, remaining, self.secs, self.tp,
                self.vconf.view(b, k), self.vpres.view(b, k, t), self.config,
            )
        act = self.active[:, None]
        self.scores.copy_(torch.where(act, scores, self.scores))
        self.visited.copy_(torch.where(act, self.new_visited, self.visited))
        self.P.copy_(torch.where(act, self.new_P, self.P))
        self.remaining.copy_(torch.where(act, remaining, self.remaining))
        self.budget.copy_(torch.where(self.active, self.budget - k, self.budget))
        self.iteration.copy_(torch.where(self.active, self.iteration + 1, self.iteration))
        self.flags.copy_(self.remaining.any(dim=-1) & (self.budget > 0))
        if self.history:
            self._snapshot()

    def _snapshot(self) -> None:
        """Copy the step's snapshot into history row ``hstep`` (device to
        device, no read), then count the step."""
        row = torch.clamp(self.hstep, max=self.cap - 1).view(1)
        src = {"active": self.active, "secs": self.secs, "conf": self.conf, "P": self.P,
               "scores": self.scores, "visited": self.visited}
        if self.dets is not None:
            src.update({"det_" + k: v for k, v in self.dets.items()})
        for k, v in src.items():
            if k not in self.hist:
                self.hist[k] = torch.zeros((self.cap, *v.shape), dtype=v.dtype, device=self.dev)
            self.hist[k].index_copy_(0, row, v[None])
        self.hstep += 1

    def history_rows(self) -> List[Dict[str, Any]]:
        """The run's history, one dict of host arrays a step (read once):
        {"active" (B,), "secs" (B, K), "conf" (B, K), "P", "scores",
        "visited" (B, N_pad)[, "detections": {"scores", "class_ids", "boxes",
        "valid"} with a leading B axis]}."""
        with trace("search.history"):
            host = {k: v[:self._steps].cpu().numpy() for k, v in self.hist.items()}
            rows = []
            for t in range(self._steps):
                row = {k: host[k][t] for k in ("active", "secs", "conf", "P", "scores", "visited")}
                if self.dets is not None:
                    row["detections"] = {k: host["det_" + k][t] for k in self.dets}
                rows.append(row)
            return rows

    # -- graphs ---------------------------------------------------------------
    def _run(self, name: str, eager: Callable[[], None],
             capture: Optional[Callable[[], None]] = None) -> None:
        """Run a phase: replay its graph, or (first use, or no graphs) run it
        eagerly and, with graphs, capture it for the next use; the noise
        generators are registered with (a) and (a1)."""
        self.graphs.run(name, eager, self.stats, capture,
                        self.rngs if name in ("a", "a1") else ())

    # -- reads ----------------------------------------------------------------
    def _read(self, t: torch.Tensor, name: str) -> List:
        """One designated read: a non-blocking copy into pinned memory,
        awaited on an event."""
        if self.dev.type != "cuda":
            with trace("search.read"):
                vals = t.reshape(-1).tolist()
        else:
            host = self._pinned[name]
            host.copy_(t, non_blocking=True)
            self._event.record()
            with trace("search.read"):
                self._event.synchronize()
                vals = host.reshape(-1).tolist()
        if self.model_tp is not None:
            agree([int(v) for v in vals], self.model_tp, f"the step's {name!r} read",
                  self.dev)
        return vals

    # -- driving --------------------------------------------------------------
    def setup(self) -> List[bool]:
        """The read before the first step: which videos search, and each
        one's iteration count."""
        flags = self.remaining.any(dim=-1) & (self.budget > 0)
        with trace("search.setup"):      # its read is the one ``search.read`` outside a step
            vals = self._read(torch.cat([flags.to(torch.int64), self.iteration, self.budget]),
                              "setup")
        self.stats.setup_reads += 1
        self._it0 = vals[self.b:2 * self.b]
        # the most steps any video's budget allows: the history's rows
        self.cap = max(1, max(-(-int(v) // self.k) for v in vals[2 * self.b:]))
        self.hstep.zero_()
        self._steps = 0
        self._saved: Dict[int, torch.Tensor] = {}
        return [bool(v) for v in vals[:self.b]]

    def step(self, active: List[bool]) -> List[bool]:
        """One step of the videos flagged ``active`` (host copy of the
        previous flags; ``setup`` first); returns the new flags."""
        with trace("search.step"):
            return self._step(active)

    def _step(self, active: List[bool]) -> List[bool]:
        is_first = [it + self._steps == 0 for it in self._it0]
        draw = [a and not f for a, f in zip(active, is_first)]
        graphed = self.graphs.enabled and not any(a and f for a, f in zip(active, is_first))
        if graphed:
            # a replay of (a) draws for every video: keep the noise state of
            # the finished ones for their final pop
            for i, a in enumerate(active):
                if not a and i not in self._saved:
                    self._saved[i] = self.rngs[i].get_state()
            first = None
        else:
            first = (self.iteration == 0) if any(is_first) else None

        def run(name, eager, capture=None):
            if graphed:
                self._run(name, eager, capture)
            else:
                eager()

        every = [True] * self.b
        if self.paged is None:
            with trace("search.phase.a", device=self.dev):
                run("a", lambda: self._phase_a(first, draw), lambda: self._phase_a(None, every))
        else:
            with trace("search.phase.a", device=self.dev):
                run("a1", lambda: self._phase_a1(first, draw),
                    lambda: self._phase_a1(None, every))
            self._fetch_frames()
            with trace("search.phase.a", device=self.dev):
                run("a2", self._phase_a2)
        self.stats.grid_images += self.b
        if self.stats.record:
            # the sampler's inputs too: P and visited are still the step's own
            self.stats.trace.append({"active": list(active), "secs": self.secs.clone(),
                                     "conf": self.conf.clone(), "P": self.P.clone(),
                                     "visited": self.visited.clone(),
                                     "gumbel": self.gumbel.clone(),
                                     "n_valid": self.n_valid.clone()})
        if self.verify:
            count = self._read(self.n_cand, "count")[0]
            self.stats.host_reads += 1
            with trace("search.phase.verify", device=self.dev):
                self._verify(count)
        with trace("search.phase.c", device=self.dev):
            self._run("c", self._phase_c)
        flags = [bool(v) for v in self._read(self.flags, "flags")]
        self.stats.host_reads += 1
        self.stats.steps += 1
        self._steps += 1
        return flags

    def _verify(self, count: int) -> None:
        """Rescore ``count`` candidates: one wide forward, or rounds."""
        if count == 0:
            return
        k, t = self.k, self.width
        wide = t >= k or (self.mode == "single" and self.config.verify_adaptive
                          and count * 2 > k)
        if wide:
            self._run("wide", self._phase_wide)
            self.stats.verify_widths.append(self.b * k)
            return
        for _ in range(-(-count // t)):
            self._run("round", self._phase_round)
            self.stats.verify_widths.append(t * (self.b if self.mode == "per_video" else 1))

    def run(self, max_iterations: Optional[int]) -> int:
        """Step until no video searches or ``max_iterations`` steps; put the
        finished videos' noise state back.  Returns the steps taken."""
        active = self.setup()
        while any(active) and (max_iterations is None or self._steps < max_iterations):
            active = self.step(active)
        for i, state in self._saved.items():
            self.rngs[i].set_state(state)
        return self._steps


@torch.no_grad()
def history_lists(rows, n_valid: int, video: Optional[int] = None) -> Tuple[list, ...]:
    """The searcher's five histories from history snapshots (the engine's
    single-video ones, or ``Stepper.history_rows``' batched ones with
    ``video``, over the steps that video was active): ``P_history``,
    ``Score_history`` and ``non_visiting_history`` (1 - visited) over the
    first ``n_valid`` frames as lists, ``sampled_history`` and
    ``detect_bbox_iters`` (each step's boxes, scores and class ids masked by
    ``valid``, host arrays; empty without detections)."""
    pick = (lambda a: a) if video is None else (lambda a: a[video])  # noqa: E731
    p_hist, s_hist, nv_hist, samp, dets = [], [], [], [], []
    for snap in rows:
        if video is not None and not snap["active"][video]:
            continue
        p_hist.append(pick(snap["P"])[:n_valid].tolist())
        s_hist.append(pick(snap["scores"])[:n_valid].tolist())
        nv_hist.append((1.0 - pick(snap["visited"])[:n_valid].astype(np.float32)).tolist())
        samp.append(pick(snap["secs"]).tolist())
        if "detections" in snap:
            d = {k: pick(v) for k, v in snap["detections"].items()}
            dets.append({k: d[k][d["valid"]] for k in ("boxes", "scores", "class_ids")})
    return p_hist, s_hist, nv_hist, samp, dets


def run_single(state: SearchState, scorer, config: SearchConfig,
               max_iterations: Optional[int], graphs: Optional[bool],
               stats: Optional[StepStats], history: bool = False, paged=None):
    """Step one video's search to its end (or ``max_iterations`` steps),
    from the scorer's resident cache or, with ``paged``, a streaming
    cache's frames.  Returns the final state, and with ``history`` also the
    history rows of ``Stepper.history_rows`` with the video axis dropped."""
    stepper = Stepper.single(state, scorer, config, graphs, stats, history, paged)
    steps = stepper.run(max_iterations)
    final = stepper.single_state(state, steps)
    if not history:
        return final
    rows = []
    for row in stepper.history_rows():
        one = {k: row[k][0] for k in ("P", "scores", "visited", "secs", "conf")}
        if "detections" in row:
            one["detections"] = {k: v[0] for k, v in row["detections"].items()}
        rows.append(one)
    return final, rows
