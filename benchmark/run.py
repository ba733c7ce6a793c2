"""The benchmark of the PyTorch/CUDA port (``tstar_tpu_torch``): one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  One process: it loads the kernel library
(built into ``tstar_tpu_torch/_build/`` by the first run in a checkout),
lets the cell's driver (``benchmark/drivers/<driver>.py``) seed the weights
and make the inputs on the device from ``--seed`` and warm every shape the
cell uses, then measures for ``--seconds`` (to the driver's next boundary).
Everything before the window is ``setup_s``.  ``--trace 0`` reports the
cell's end-to-end metrics; ``--trace 1`` runs the window under
``torch.profiler`` and reports its per-layer metrics, each read by
``benchmark/metrics/<metric>.py``, with the device's busy and window seconds
and a breakdown.  After the window the program's state is freed and the
driver compares what the window produced with the plain reference
(``benchmark/reference/``); each number compared is printed beside its
limit, last on standard error and last in the result.

The last line of standard output is the result, one JSON object.  A run
exits non-zero with no result when it finds no CUDA device (or fewer than
the cell asks for), or when ``jax``, ``jaxlib``, ``flax`` or ``tstar_tpu``
is loaded in the process after the window.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tstar_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def measure(manifest, cell_name: str, seed: int, seconds: float, trace: bool, device: str,
            t0: float) -> Dict:
    """Set up, measure and check one run of ``cell_name`` on ``device``;
    returns the result object (without the jax check)."""
    import torch

    from benchmark import trace as tr

    cell = manifest.cell(cell_name)
    config = manifest.config(cell["config"])
    # further configurations the cell names by key, as a detector beside a VLM
    configs = {k: manifest.config(v) for k, v in cell.items() if k.endswith("_config")}
    driver = manifest.driver(cell["driver"]).Driver(cell, config, seed, device, configs, trace)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        from tstar_tpu_torch.kernels import _build
        _build.load()
    driver.setup()
    setup_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    record: Dict = {}
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("benchmark.window"):
                driver.window(seconds)
        by_name, intervals, host = tr.profile_events(prof)
        spans = [h for h in host if h[2] == "benchmark.window"]
        start, end = (spans[0][0], spans[0][1]) if spans else (0, 0)
        inside = [(max(s, start), min(e, end)) for s, e in intervals if e > start and s < end]
        record = {"window_s": (end - start) / 1e9, "busy_s": tr.union_ns(inside) / 1e9,
                  "device_ops": by_name, "counters": driver.counters()}
        breakdown = {
            "device_ops": [[k[:120], v[0] / 1e3] for k, v in
                           sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]],
            "idle_gaps": tr.idle_gaps(intervals, host, (start, end)),
        }
    else:
        driver.window(seconds)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": int(cell.get("chips", 1)),
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if on_card else 0}
    if trace:
        dev.update(busy_s=record["busy_s"], window_s=record["window_s"])

    units = {m["name"]: m["unit"] for m in manifest.spec["end_to_end"] + manifest.spec["per_layer"]}
    metrics: Dict[str, Dict] = {}
    if trace:
        for m in manifest.per_layer(cell_name):
            value = manifest.reader(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": units[m["name"]]}
    else:
        values = dict(driver.end_to_end(), setup_s=setup_s)
        for m in manifest.end_to_end(cell_name):
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    attempted = driver.attempted()
    driver.release()
    checks = driver.check()
    failed = int(getattr(driver, "failed", 0))
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.manifest import Manifest

    manifest = Manifest()
    chips = int(manifest.cell(args.workload).get("chips", 1))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 3
    print(card_line(), flush=True)
    result = measure(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
                     "cuda:0", _T0)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded in this process: {bad}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
