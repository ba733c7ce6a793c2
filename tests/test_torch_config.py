"""The port's own SearchConfig (tstar_tpu_torch/utils/config.py) against the
reference's (tstar_tpu/utils/config.py): the same fields, types and defaults,
and the same derived values on a grid of inputs."""

import dataclasses
import itertools

import pytest

from tstar_tpu.utils.config import SearchConfig as JSearchConfig
from tstar_tpu_torch import SearchConfig as PackageSearchConfig
from tstar_tpu_torch.utils.config import SearchConfig as TSearchConfig


def test_fields_types_defaults_match():
    want = [(f.name, f.type, f.default) for f in dataclasses.fields(JSearchConfig)]
    got = [(f.name, f.type, f.default) for f in dataclasses.fields(TSearchConfig)]
    assert got == want
    assert TSearchConfig() == TSearchConfig(**dataclasses.asdict(JSearchConfig()))
    assert PackageSearchConfig is TSearchConfig
    assert TSearchConfig.__dataclass_params__.frozen


@pytest.mark.parametrize("budget,cap,rows,max_it", [
    (0.5, 1000, 4, None), (1.0, 48, 4, None), (0.1, 1000, 2, None), (2.5, 1000, 4, 7),
])
def test_derived_values_match(budget, cap, rows, max_it):
    kw = dict(search_budget=budget, budget_cap=cap, grid_rows=rows, max_iterations=max_it)
    j, t = JSearchConfig(**kw), TSearchConfig(**kw)
    assert t.frames_per_iteration == j.frames_per_iteration
    for n, pad in itertools.product((1, 20, 127, 128, 129, 600, 3601), (64, 128)):
        jp, tp = dataclasses.replace(j, frame_pad_multiple=pad), dataclasses.replace(t, frame_pad_multiple=pad)
        assert tp.budget_frames(n) == jp.budget_frames(n)
        assert tp.iteration_cap(n) == jp.iteration_cap(n)
        assert tp.padded_frames(n) == jp.padded_frames(n)
