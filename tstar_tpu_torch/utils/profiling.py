"""Tracing and structured metrics (port of ``tstar_tpu/utils/profiling.py``).

* ``trace(name)``: a ``torch.profiler.record_function`` range, visible in a
  profile of the run;
* ``StageTimer``: wall seconds per named stage across a run (grounding /
  decode_and_setup / search / qa).  On a CUDA device each stage ends with
  ``torch.cuda.synchronize()``, so a stage's seconds hold its device work;
* ``MetricsLogger``: an append-only JSONL sink;
* ``start_device_profile`` / ``stop_device_profile``: a ``torch.profiler``
  trace of the CPU and the card, written as a chrome trace into ``logdir``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(name: str) -> Iterator[None]:
    with torch.profiler.record_function(name):
        yield


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


class MetricsLogger:
    """Append-only JSONL metrics sink."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, record: Dict) -> None:
        record = dict(record, ts=time.time())
        if self.path:
            with open(self.path, "a", encoding="utf-8") as f:
                json.dump(record, f, ensure_ascii=False)
                f.write("\n")


_PROFILE: Dict[str, object] = {}


def start_device_profile(logdir: str) -> None:
    """Start a ``torch.profiler`` trace of the CPU and, where there is one,
    the card."""
    if _PROFILE:
        raise RuntimeError("a device profile is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _PROFILE.update(prof=prof, logdir=logdir)


def stop_device_profile() -> str:
    """Stop the trace and write it to ``<logdir>/trace.json``; returns the
    path."""
    prof, logdir = _PROFILE.pop("prof"), _PROFILE.pop("logdir")
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    return path
