"""CUDA-graph capture and replay of the port's steps over static buffers:
the search's phases (``search/step_graphs.py``) and the VLM decode step
(``models/generate.py``).

A ``StepGraphs`` holds its owner's graphs by name, in one memory pool.  A
name's first use runs its body eagerly on the capture stream, which builds
the lazy per-device constants, cuBLAS's state for that stream and the
kernel library, then captures the body; every later use replays the graph.
The eager run's kernel launches (the wrappers' counts,
``kernels.launch_counts``) are kept as the body's ``launches``, with graphs
or without and on the CPU.  A capture records launches without running
them: they are taken off the wrappers' counts, and every replay adds them
back.  A capture that fails puts back every generator it registered (the
default CUDA generator, which every capture registers, and the ones given)
and raises ``GraphCaptureError``: there is no fallback.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from tstar_tpu_torch.kernels import add_launch_counts, launch_counts
from tstar_tpu_torch.utils.profiling import trace


logger = logging.getLogger(__name__)


class GraphCaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph."""


def use_graphs(graphs: Optional[bool], device: torch.device, blocker: str = "",
               stats=None) -> bool:
    """Whether steps on ``device`` run through CUDA graphs: by default on a
    CUDA device, unless ``blocker`` says why the model's steps cannot be
    captured (``models/tensor_parallel.graph_blocker``): then the reason is
    logged and kept in ``stats.eager_reason``, and ``graphs=True`` raises."""
    if graphs and device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
    if not (device.type == "cuda" if graphs is None else graphs):
        return False
    if blocker:
        if graphs:
            raise ValueError(f"graphs=True, but {blocker}")
        if stats.eager_reason != blocker:
            logger.info("stepping eagerly: %s", blocker)
        stats.eager_reason = blocker
    return not blocker


_CAPTURE_STREAMS: Dict[Tuple[int, int], "torch.cuda.Stream"] = {}


def capture_stream(dev: torch.device) -> "torch.cuda.Stream":
    """The side stream every capture on ``dev`` in this thread runs on.
    cuBLAS keeps a workspace for each stream it runs on, so a new stream for
    each search or decode bucket would allocate another one each time until
    PyTorch's pool of streams comes round again."""
    key = (dev.index if dev.index is not None else torch.cuda.current_device(),
           threading.get_ident())
    if key not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[key] = torch.cuda.Stream(device=key[0])
    return _CAPTURE_STREAMS[key]


def _launched(before: Dict[str, int]) -> Dict[str, int]:
    """The wrappers' launches since ``before`` (nonzero only)."""
    return {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}


class StepGraphs:
    """An owner's steps by name: CUDA graphs in one memory pool when
    ``enabled``, eager bodies otherwise.  ``what`` names the steps in
    errors; ``span`` (if any) wraps each first use, its eager run and
    capture."""

    def __init__(self, device: torch.device, enabled: bool, what: str,
                 span: Optional[str] = None):
        self.device, self.enabled, self.what, self.span = device, enabled, what, span
        self.launches: Dict[str, Dict[str, int]] = {}    # each body's first, eager run
        self._graphs: Dict[str, Tuple[torch.cuda.CUDAGraph, Dict[str, int]]] = {}
        if enabled:
            self.stream = capture_stream(device)
            self._pool = torch.cuda.graph_pool_handle()

    def __contains__(self, name: str) -> bool:
        return name in self._graphs

    def run(self, name: str, body: Callable[[], None], stats,
            capture: Optional[Callable[[], None]] = None,
            generators: Sequence[torch.Generator] = ()) -> None:
        """Run step ``name``: replay its graph, or run ``body`` eagerly and,
        enabled, capture ``capture`` (default ``body``) after that first run,
        with ``generators`` registered.  ``stats`` counts the ``captures``
        and ``replays``."""
        g = self._graphs.get(name)
        if g is not None:
            g[0].replay()
            if g[1]:
                add_launch_counts(g[1])
            stats.replays += 1
            return
        if not self.enabled:
            self._eager(name, body)
            return
        with trace(self.span) if self.span else contextlib.nullcontext():
            current = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                self._eager(name, body)
            current.wait_stream(self.stream)
            self._graphs[name] = self._capture(name, capture or body, generators)
        stats.captures += 1

    def _eager(self, name: str, body: Callable[[], None]) -> None:
        if name in self.launches:
            body()
            return
        before = launch_counts()
        body()
        self.launches[name] = _launched(before)

    def _capture(self, name: str, body: Callable[[], None],
                 generators: Sequence[torch.Generator]):
        graph = torch.cuda.CUDAGraph()
        index = self.device.index if self.device.index is not None else torch.cuda.current_device()
        gens = [torch.cuda.default_generators[index]]     # every capture registers it
        if generators:
            register = getattr(graph, "register_generator_state", None)
            if register is None:
                raise GraphCaptureError(
                    "this PyTorch cannot register a generator with a CUDA graph")
            for gen in generators:
                register(gen)
            gens += generators
        # a capture that fails leaves its generators' states in capture mode
        # (no eager draw works from them again): swap in clean copies then
        clean = [(gen, gen.clone_state()) for gen in gens]

        def failed(e):
            for gen, state in clean:
                gen.graphsafe_set_state(state)
            return GraphCaptureError(f"capturing {self.what} {name!r} failed: {e}")

        before = launch_counts()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        try:
            with torch.cuda.stream(self.stream):
                graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                try:
                    body()
                except BaseException as e:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass
                    raise failed(e) from e
                try:
                    graph.capture_end()
                except RuntimeError as e:
                    raise failed(e) from e
        finally:
            # the capture recorded launches without running them
            launches = _launched(before)
            add_launch_counts({k: -n for k, n in launches.items()})
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        return graph, launches
