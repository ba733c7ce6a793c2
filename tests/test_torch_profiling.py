"""The port's span layer (``utils/profiling.py``) on the CPU: with no
profiler a span does nothing but check for one; under ``torch.profiler``
each span is a host event of the profile and a registry entry whose count
and host seconds match it; device spans resolve their events only in
``snapshot()`` and record none inside a graph capture; the search, the VLM
backend and the frame cache open their spans where the work happens; and
the benchmark's seven span readers (``benchmark/metrics/``) read the
registry.  This file imports no JAX.

A stand-in for the card's timing events (``fake_card``) lets the device
half run here: each event's record advances a clock by 1.5 ms.
"""

import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tstar_tpu_torch.framework.heuristics import initialize_heuristic
from tstar_tpu_torch.parallel.multi_video import VideoTask, search_videos
from tstar_tpu_torch.search.searcher import KeyframeSearcher
from tstar_tpu_torch.utils import profiling
from tstar_tpu_torch.utils.config import SearchConfig
from tstar_tpu_torch.utils.profiling import snapshot, trace
from tstar_tpu_torch.video.synthetic import default_scene, scene_variant

METRICS = Path(__file__).resolve().parents[1] / "benchmark" / "metrics"
CFG = SearchConfig(cache_hw=(32, 64))
CARD = torch.device("cuda", 0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _empty_registry():
    profiling.reset()
    yield
    profiling.reset()


def profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def host_events(prof, name):
    return [e for e in prof.events() if e.name == name]


class _FakeEvent:
    clock_ms = 0.0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        _FakeEvent.clock_ms += 1.5
        self.t = _FakeEvent.clock_ms

    def synchronize(self):
        assert self.t is not None

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def fake_card(monkeypatch):
    """CUDA's timing events, current stream and capture flag stood in for;
    ``capturing[0]`` says whether the stream captures."""
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    return capturing


def reader(name):
    spec = importlib.util.spec_from_file_location(f"span_reader_{name}", METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# -- the primitive --------------------------------------------------------------


def test_no_profiler_no_range_clock_or_event(monkeypatch):
    """With no profiler a span opens no ``record_function``, reads no clock,
    records no event (even a device span) and leaves the registry empty."""
    def boom(*a, **k):
        raise AssertionError("called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(profiling.time, "perf_counter", boom)
    try:
        for device in (False, True, CARD):
            with trace("x.off", device=device) as span:
                torch.ones(4).sum()
            assert span is None
    finally:
        monkeypatch.undo()
    assert snapshot() == {}


def test_counts_and_host_seconds_match_the_profile():
    """Under the profiler each span is one host event of its name, and its
    host seconds lie within 5% (or 1 ms) of those events' summed length."""
    with profiled() as prof:
        for i in range(5):
            with trace("x.outer"):
                time.sleep(0.02)
                with trace("x.inner"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
                    time.sleep(0.01)
        with trace("x.inner"):
            pass
    snap = snapshot()
    assert set(snap) == {"x.outer", "x.inner"}
    for name, count in (("x.outer", 5), ("x.inner", 6)):
        events = host_events(prof, name)
        assert snap[name]["count"] == len(events) == count
        total_s = sum(e.time_range.elapsed_us() for e in events) / 1e6
        assert abs(snap[name]["host_s"] - total_s) <= max(0.05 * total_s, 1e-3)
        assert snap[name]["device_ms"] is None
    assert snap["x.outer"]["host_s"] > snap["x.inner"]["host_s"] >= 5 * 0.01


def test_device_span_on_the_cpu_times_no_device():
    with profiled():
        with trace("x.dev", device=True):
            torch.ones(4).sum()
        with trace("x.dev", device=torch.device("cpu")):
            torch.ones(4).sum()
    snap = snapshot()["x.dev"]
    assert snap["count"] == 2 and snap["device_ms"] is None


def test_reset_clears_the_registry():
    with profiled():
        with trace("x.a"):
            pass
    assert snapshot()["x.a"]["count"] == 1
    profiling.reset()
    assert snapshot() == {}
    with trace("x.a"):          # no profiler: nothing comes back
        pass
    assert snapshot() == {}


def test_device_events_resolve_in_snapshot_and_skip_captures(fake_card):
    """A device span records a start and an end event on the current stream
    and resolves them only in ``snapshot()``; a span opened while the
    stream captures records none; ``timed`` records the events with no
    profiler for the caller alone."""
    with profiled():
        with trace("x.dev", device=CARD) as span:
            pass
        assert profiling._SPANS["x.dev"].pending == [span.events]
        assert span.device_ms() == 1.5
        fake_card[0] = True
        with trace("x.dev", device=CARD) as captured:
            pass
        with trace("x.captured", device=CARD):
            pass
        fake_card[0] = False
    assert captured.events is None
    snap = snapshot()
    assert snap["x.dev"] == {"count": 2, "host_s": snap["x.dev"]["host_s"], "device_ms": 1.5}
    assert snap["x.captured"]["device_ms"] is None
    assert profiling._SPANS["x.dev"].pending == []
    with trace("x.timed", device=CARD, timed=True) as span:
        pass
    assert span.device_ms() == 1.5 and "x.timed" not in snapshot()
    with trace("x.untimed", device=CARD) as span:
        pass
    assert span is None


def test_stage_timer_opens_its_range_only_under_a_profiler(monkeypatch):
    timer = profiling.StageTimer()
    with profiled() as prof:
        with timer.stage("grounding"):
            pass
    assert len(host_events(prof, "grounding")) == 1
    assert snapshot()["grounding"]["count"] == 1

    def boom(*a, **k):
        raise AssertionError("record_function with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    with timer.stage("grounding"):
        pass
    assert timer.report()["grounding"]["count"] == 2


# -- spans where the work happens -------------------------------------------------


def _searcher(seed=0):
    return KeyframeSearcher("mem://scene", initialize_heuristic("color-probe", device="cpu"),
                            ["couch"], ["tv"], search_budget=0.5, confidence_threshold=2.0,
                            config=CFG, seed=seed, decoder=default_scene(120.0))


def test_search_step_and_read_spans_count_the_engine_steps():
    """A CPU search: one ``search.step`` a step, one ``search.read`` a host
    read (the setup read in ``search.setup``), one ``video.cache``, and the
    three phase spans, with no device time on the CPU."""
    with torch.no_grad(), profiled() as prof:
        searcher = _searcher()
        searcher.search()
    st = searcher.step_stats
    snap = snapshot()
    assert st.steps >= 3
    assert snap["search.step"]["count"] == st.steps == len(host_events(prof, "search.step"))
    assert snap["search.read"]["count"] == st.host_reads + st.setup_reads
    assert snap["search.setup"]["count"] == st.setup_reads == 1
    assert snap["video.cache"]["count"] == 1
    assert snap["search.phase.a"]["count"] == snap["search.phase.c"]["count"] == st.steps
    assert snap["search.phase.verify"]["count"] == st.steps
    assert all(snap[k]["device_ms"] is None for k in snap)
    assert "search.history" not in snap and "search.capture" not in snap
    assert snap["search.step"]["host_s"] > snap["search.read"]["host_s"] - \
        snap["search.setup"]["host_s"]


def test_history_searches_record_search_history():
    with torch.no_grad(), profiled():
        _searcher().search_with_visualization()
    # the stepper's rows, then the searcher's lists
    assert snapshot()["search.history"]["count"] == 2
    profiling.reset()
    tasks = [VideoTask(f"mem://{i}", ["couch"], ["tv"], seed=i,
                       decoder=scene_variant(i, 120.0)) for i in range(2)]
    with torch.no_grad(), profiled():
        rows = search_videos(tasks, initialize_heuristic("color-probe", device="cpu"),
                             SearchConfig(cache_hw=(32, 64), search_budget=0.5,
                                          confidence_threshold=2.0),
                             collect_history=True)
    assert all(r["P_history"] for r in rows)
    # the batched rows once, then each video's lists
    assert snapshot()["search.history"]["count"] == 1 + len(tasks)


def test_vlm_backend_spans_prepare_prefill_and_decode(tmp_path):
    from tstar_tpu_torch.grounding.vlm_backend import TorchVLMBackend
    from tstar_tpu_torch.models.generate import GenerateStats
    from tstar_tpu_torch.models.llava_onevision import LlavaOnevisionConfig, LlavaOnevisionModel
    from tstar_tpu_torch.models.qwen2vl import Qwen2VLTextConfig, init_random_
    from tstar_tpu_torch.models.qwen_tokenizer import (SPECIAL_TOKENS, QwenTokenizer,
                                                       write_byte_vocab)
    from tstar_tpu_torch.models.siglip import SiglipVisionConfig

    special = {tok: 256 + i for i, tok in enumerate(SPECIAL_TOKENS)}
    model = LlavaOnevisionModel(LlavaOnevisionConfig(
        vision=SiglipVisionConfig(hidden_size=16, num_layers=2, num_heads=2,
                                  intermediate_size=32, patch_size=2, image_size=8),
        text=Qwen2VLTextConfig(vocab_size=300, hidden_size=32, num_layers=2, num_heads=4,
                               num_kv_heads=2, intermediate_size=64, rope_theta=10000.0,
                               tie_word_embeddings=False, mrope_section=(4, 0, 0)),
        image_token_id=special["<|image_pad|>"], video_token_id=special["<|video_pad|>"]))
    model = init_random_(model, torch.Generator().manual_seed(0)).eval()
    write_byte_vocab(str(tmp_path), special)
    backend = TorchVLMBackend.from_model(model, QwenTokenizer.from_dir(str(tmp_path)))
    backend.stats = GenerateStats(timed=True)
    frames = [np.full((16, 16, 3), 60 * i, np.uint8) for i in range(2)]
    with torch.no_grad(), profiled():
        backend.inference_with_frames("what?", frames, temperature=0.0, max_tokens=4)
        backend.inference_with_frames("and?", frames, temperature=0.0, max_tokens=3)
    snap = snapshot()
    for name in ("vlm.prepare", "generate.prefill", "generate.decode"):
        assert snap[name]["count"] == 2 and snap[name]["device_ms"] is None, name
    # the CPU has no device clock: timed stats stay empty there
    assert backend.stats.prefill_ms == [] and backend.stats.decode_ms == []


# -- the benchmark's readers ---------------------------------------------------------

SEARCH_READERS = ("history_host_pct", "capture_pct", "step_host_ms", "verify_ms_per_step")
PIPELINE_READERS = ("vlm_prepare_s", "prefill_ms", "cache_build_s")
RECORD = {"window_s": 2.0, "counters": {"steps": 4, "questions": 2}}


@pytest.mark.parametrize("name", SEARCH_READERS + PIPELINE_READERS)
def test_readers_read_nothing_from_an_empty_registry(name):
    assert reader(name).read(RECORD) is None
    with trace(name):           # no profiler: still nothing
        pass
    assert reader(name).read(RECORD) is None


def _fill(fake_card):
    """Spans of every name the readers read, under the profiler."""
    with profiled():
        for _ in range(3):
            with trace("search.setup"):
                with trace("search.read"):
                    time.sleep(0.001)
            for _ in range(4):
                with trace("search.step"):
                    with trace("search.phase.verify", device=CARD):
                        pass
                    with trace("search.read"):
                        time.sleep(0.001)
                    time.sleep(0.0005)
            with trace("search.history"):
                time.sleep(0.002)
            with trace("search.capture"):
                time.sleep(0.001)
        for _ in range(2):
            with trace("video.cache"):
                time.sleep(0.001)
            with trace("vlm.prepare"):
                time.sleep(0.001)
            with trace("generate.prefill", device=CARD):
                pass
    return snapshot()


@pytest.mark.parametrize("name", SEARCH_READERS + PIPELINE_READERS)
def test_readers_read_the_spans(name, fake_card):
    s = _fill(fake_card)
    steps, questions, window = 12, 2, 2.0
    record = {"window_s": window, "counters": {"steps": steps, "questions": questions}}
    want = {
        "history_host_pct": 100.0 * s["search.history"]["host_s"] / window,
        "capture_pct": 100.0 * s["search.capture"]["host_s"] / window,
        "step_host_ms": 1e3 * (s["search.step"]["host_s"] - s["search.read"]["host_s"]
                               + s["search.setup"]["host_s"]) / steps,
        "verify_ms_per_step": 1.5 * 12 / steps,
        "vlm_prepare_s": s["vlm.prepare"]["host_s"] / questions,
        "prefill_ms": 1.5,
        "cache_build_s": s["video.cache"]["host_s"] / questions,
    }[name]
    got = reader(name).read(record)
    assert got == pytest.approx(want, rel=1e-12)
    assert got > 0
    # a step's host time outside its reads holds its 0.5 ms sleep, and no
    # read: counting the setup reads as a step's would take 0.25 ms off
    if name == "step_host_ms":
        assert got > 0.45
