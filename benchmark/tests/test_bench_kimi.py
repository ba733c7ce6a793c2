"""The Kimi-VL cell (``drivers/kimi_pipeline.py``): a whole run on the CPU at
tiny sizes, past the look for a card, comes out correct; with a served token
or an expert choice altered where the program makes it, not correct.  On
the card, at the cell's own size, the control (the reference one precision
down, fp8 e4m3 operands, in the program's place) comes out not correct, and
so does the altered expert choice, by ``route_gap``:

    python -m pytest -m cuda benchmark/tests/test_bench_kimi.py -s

prints each seed's readings beside the program's own, the numbers the
limits in ``benchmark/workloads/kimi-vl-a3b-instruct.question.json`` were set
between."""

from __future__ import annotations

import gc
import json
import time

import pytest

from benchmark.manifest import Manifest
from benchmark.run import measure

from .conftest import make_tiny_root

KIMI = "kimi-vl-a3b-instruct.question"


@pytest.fixture(scope="module")
def kimi_root(tmp_path_factory):
    root = make_tiny_root(tmp_path_factory.mktemp("tiny_kimi"))
    path = root / "benchmark/configs/kimi-vl-a3b-instruct.json"
    cfg = json.loads(path.read_text())
    cfg.update(hidden_size=128, intermediate_size=256, moe_intermediate_size=32,
               num_hidden_layers=3, num_attention_heads=2, kv_lora_rank=32, qk_nope_head_dim=16,
               qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8, num_experts_per_tok=3)
    cfg["vision_config"].update(hidden_size=64, intermediate_size=96, num_attention_heads=2,
                                num_hidden_layers=2)
    path.write_text(json.dumps(cfg))
    path = root / f"benchmark/workloads/{KIMI}.json"
    wl = json.loads(path.read_text())
    wl["mix"].update(video_seconds=120, cache_hw=[32, 64], video_hw=[72, 128])
    path.write_text(json.dumps(wl))
    return root


def _run(root, seed=5):
    m = Manifest(root, root / "benchmark")
    return measure(m, KIMI, seed, 0.1, False, "cpu", time.perf_counter())


def _token_altered(monkeypatch):
    """One served token of each request altered where the decode picks it."""
    from tstar_tpu_torch.models import generate

    sample, calls = generate._sample, [0]

    def altered(logits, *args, **kw):
        token = sample(logits, *args, **kw)
        calls[0] += 1
        return (token + 1) % logits.shape[-1] if calls[0] % 7 == 3 else token

    monkeypatch.setattr(generate, "_sample", altered)


def _expert_altered(monkeypatch):
    """One token's last expert swapped for its first unchosen one (the 7th
    by sigmoid score plus bias) in every tenth routing, where the router
    picks them: the plain router (prefill; the decode step on the CPU) and
    the router kernel (the decode step on the card, so that a captured step
    replays the swap at every position)."""
    import torch

    from tstar_tpu_torch.models import kimi_vl

    calls = [0]

    def altering(router):
        def altered(x, gate, bias, k, scale):
            ids, w = router(x, gate, bias, k, scale)
            calls[0] += 1
            if calls[0] % 10 == 4:
                scores = torch.sigmoid(x.float() @ gate.float().t()) + bias.float()
                ids = ids.clone()
                ids[0, -1] = torch.topk(scores, k + 1, dim=-1).indices[0, -1]
            return ids, w
        return altered

    monkeypatch.setattr(kimi_vl, "route", altering(kimi_vl.route))
    monkeypatch.setattr(kimi_vl, "moe_route", altering(kimi_vl.moe_route))


@pytest.mark.parametrize("fault", [None, _token_altered, _expert_altered],
                         ids=lambda f: "sound" if f is None else f.__name__.strip("_"))
def test_kimi_sound_and_broken(kimi_root, monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    result = _run(kimi_root)
    assert result["correct"] == (fault is None), result["checks"]
    assert result["attempted"] >= 1


def _card_driver(card, seed):
    """The cell's driver at its own size on the card, set up, one window
    of a second served and the program's state released."""
    m = Manifest()
    cell = m.cell(KIMI)
    configs = {k: m.config(v) for k, v in cell.items() if k.endswith("_config")}
    driver = m.driver(cell["driver"]).Driver(cell, m.config(cell["config"]), seed, card, configs)
    driver.setup()
    driver.window(1.0)
    driver.release()
    return driver


def _free():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [9001, 9002, 9003])
def test_control_is_not_correct(card, seed):
    driver = _card_driver(card, seed)
    program = driver.check()
    control = driver.check(control=True)
    print(f"{KIMI} seed {seed} program { {c['name']: c['value'] for c in program} } control "
          f"{ {c['name']: c['value'] for c in control} }", flush=True)
    assert all(c["value"] <= c["limit"] for c in program)
    assert not all(c["value"] <= c["limit"] for c in control)
    del driver
    _free()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(2147483901, 2147483907))
def test_expert_altered_is_not_correct_at_the_cells_size(card, monkeypatch, seed):
    """The CPU run's planted routing fault at the cell's own size (64
    experts, the seeded router): ``route_gap`` alone must catch it, since
    the reference follows the program's choice."""
    _expert_altered(monkeypatch)
    driver = _card_driver(card, seed)
    readings = {c["name"]: (c["value"], c["limit"]) for c in driver.check()}
    print(f"{KIMI} seed {seed} expert altered: {readings}", flush=True)
    value, limit = readings["route_gap"]
    assert value > limit
    del driver
    _free()
