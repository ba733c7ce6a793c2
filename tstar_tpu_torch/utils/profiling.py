"""The port's spans and stage timers (port of ``tstar_tpu/utils/profiling.py``).

* ``trace(name, device=False)``: a span.  With no profiler running it does
  nothing but check that none runs (``torch.autograd._profiler_enabled``):
  no ``record_function``, no clock read, no event.  Under a profiler
  (``torch.profiler.profile``) it opens ``record_function(name)``, so the
  span lands in the profile's host events on the device trace's clock, and
  adds its count and host seconds to a process-wide registry.  With
  ``device`` (True: the current CUDA device; or a ``torch.device``) it also
  records a pair of timing events on that device's current stream, unless
  the stream is capturing a CUDA graph; their milliseconds are resolved in
  ``snapshot()``, never while the span runs.  ``timed=True`` records the
  events with no profiler too, for the caller alone: the span's
  ``device_ms()`` (``models/generate.GenerateStats(timed=True)``).
* ``snapshot()`` -> ``{name: {"count", "host_s", "device_ms"}}`` of the spans
  closed under a profiler since the last ``reset()`` (``device_ms`` None for
  a span that timed no device work).
* ``StageTimer``: wall seconds per named stage across a run (grounding /
  decode_and_setup / search / qa), each stage a span.  On a CUDA device
  each stage ends with ``torch.cuda.synchronize()``, so a stage's seconds
  hold its device work.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch

_OFF = contextlib.nullcontext()
_LOCK = threading.Lock()


class _Totals:
    __slots__ = ("count", "host_s", "device_ms", "pending")

    def __init__(self):
        self.count, self.host_s = 0, 0.0
        self.device_ms: Optional[float] = None
        self.pending: List[Tuple["torch.cuda.Event", "torch.cuda.Event"]] = []


_SPANS: Dict[str, _Totals] = {}


def _cuda(device) -> Optional[torch.device]:
    """The CUDA device a span times, or None (host only)."""
    if device is True:
        if not torch.cuda.is_initialized():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    if not device:
        return None
    device = torch.device(device)
    return device if device.type == "cuda" else None


class _Span:
    __slots__ = ("name", "device", "profiled", "events", "stream", "_range", "_t0")

    def __init__(self, name: str, device, profiled: bool):
        self.name, self.profiled = name, profiled
        self.device = _cuda(device)
        self.events = None

    def __enter__(self) -> "_Span":
        if self.profiled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self.device is not None and not torch.cuda.is_current_stream_capturing():
            self.stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        if self.profiled:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self.profiled:
            host_s = time.perf_counter() - self._t0
        if self.events is not None:
            self.events[1].record(self.stream)
        if self.profiled:
            self._range.__exit__(*exc)
            with _LOCK:
                totals = _SPANS.get(self.name)
                if totals is None:
                    totals = _SPANS[self.name] = _Totals()
                totals.count += 1
                totals.host_s += host_s
                if self.events is not None:
                    totals.pending.append(self.events)
        return False

    def device_ms(self) -> Optional[float]:
        """The span's device milliseconds (waits for its end event); None
        where it recorded no events."""
        if self.events is None:
            return None
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])


def trace(name: str, device=False, timed: bool = False):
    """A span named ``name`` (module docstring); ``with trace(...) as span``
    gives the span, or None when it does nothing."""
    profiled = torch.autograd._profiler_enabled()
    if not (profiled or timed):
        return _OFF
    return _Span(name, device, profiled)


def snapshot() -> Dict[str, Dict[str, Optional[float]]]:
    """The registry: each span's count, host seconds and device
    milliseconds (resolved here, waiting for the spans' end events)."""
    with _LOCK:
        out = {}
        for name, totals in _SPANS.items():
            for start, end in totals.pending:
                end.synchronize()
                totals.device_ms = (totals.device_ms or 0.0) + start.elapsed_time(end)
            totals.pending.clear()
            out[name] = {"count": totals.count, "host_s": totals.host_s,
                         "device_ms": totals.device_ms}
        return out


def reset() -> None:
    """Empty the registry."""
    with _LOCK:
        _SPANS.clear()


class StageTimer:
    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with trace(name):
                yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_s": round(self.totals[name] / max(1, self.counts[name]), 4),
            }
            for name in sorted(self.totals)
        }
