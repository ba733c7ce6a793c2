"""Each cell's control, on the card at the cell's own size: the reference put
in the program's place one precision down (fp8 e4m3 operands for the bf16
detector and VLM, bfloat16 for the float32 update), read on the steps and
tokens the program's window produced, has to come out as not correct on
every seed.

    python -m pytest -m cuda benchmark/tests/test_bench_control.py -s

prints each seed's readings beside the program's own, the numbers the
limits in ``benchmark/workloads/<cell>.json`` were set between."""

from __future__ import annotations

import gc

import pytest

from benchmark.manifest import Manifest

from .conftest import CELL, PIPELINE


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [9001, 9002, 9003])
@pytest.mark.parametrize("name", [CELL, PIPELINE])
def test_control_is_not_correct(card, name, seed):
    import torch

    m = Manifest()
    cell = m.cell(name)
    configs = {k: m.config(v) for k, v in cell.items() if k.endswith("_config")}
    driver = m.driver(cell["driver"]).Driver(cell, m.config(cell["config"]), seed, card, configs)
    driver.setup()
    driver.window(1.0)
    driver.release()
    program = driver.check()
    control = driver.check(control=True)
    print(f"{name} seed {seed} program { {c['name']: c['value'] for c in program} } control "
          f"{ {c['name']: c['value'] for c in control} }")
    assert all(c["value"] <= c["limit"] for c in program)
    assert not all(c["value"] <= c["limit"] for c in control)
    del driver
    gc.collect()
    torch.cuda.empty_cache()
