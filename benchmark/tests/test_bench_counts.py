"""The yardstick's arithmetic: operation and byte counts against hand sums,
the window's rate (a stall inside the window lowers it), the device-busy
union, the idle gaps and the metric readers."""

from __future__ import annotations

import time

import pytest

from benchmark import flops, trace
from benchmark.manifest import Manifest

from .conftest import CELL

B32 = {"hidden_size": 768, "intermediate_size": 3072, "num_attention_heads": 12,
       "num_hidden_layers": 12, "image_size": 768, "patch_size": 32}
TEXT = {"hidden_size": 512, "intermediate_size": 2048, "num_attention_heads": 8,
        "num_hidden_layers": 12, "max_position_embeddings": 16, "vocab_size": 49408}


def test_owlvit_image_flops_by_hand():
    s, d, m = 577, 768, 3072
    layer = 2 * s * d * 3 * d + 2 * s * d * d + 2 * 2 * s * d * m + 2 * 2 * s * s * d
    embed = 2 * 576 * (32 * 32 * 3) * d
    heads = 2 * 576 * (d * d + d * d + d * 4) + 2 * 576 * (d * 512 + d + d + 512 * 16)
    assert flops.owlvit_image_flops(B32, 512, 16, 768) == embed + 12 * layer + heads
    # the JAX benchmark's figure: about 0.11 TFLOP an image
    assert 0.10e12 < flops.owlvit_image_flops(B32, 512, 16, 768) < 0.12e12


def test_owlvit_text_flops_by_hand():
    rows, w, m = 16 * 16, 512, 2048
    layer = 2 * rows * (4 * w * w + 2 * w * m) + 4 * rows * 16 * w
    assert flops.owlvit_text_flops(TEXT, 512, 16) == 12 * layer + 2 * 16 * w * 512


def test_attention_bound_by_hand():
    t, by = flops.attention_launch_bound_s(8, 577, 12, 64)
    n_bytes = 4 * 8 * 577 * 768 * 2
    n_ops = 4 * 8 * 12 * 577 * 577 * 64
    assert by == "bytes" and t == pytest.approx(n_bytes / 3.35e12)
    assert t >= n_ops / 989e12
    t, by = flops.attention_launch_bound_s(1, 4096, 12, 64)
    assert by == "operations" and t == pytest.approx(4 * 12 * 4096 ** 2 * 64 / 989e12)


def test_busy_union_and_idle_gaps():
    iv = [(0, 10), (5, 20), (30, 40), (35, 36), (50, 60)]
    assert trace.union_ns(iv) == 20 + 10 + 10
    assert trace.merged(iv) == [(0, 20), (30, 40), (50, 60)]
    host = [(0, 100, "benchmark.window"), (20, 30, "aten::copy_"), (40, 49, "sync")]
    gaps = trace.idle_gaps(iv, host, (0, 70))
    assert gaps == [["aten::copy_", 10e-9], ["sync", 10e-9], ["benchmark.window", 10e-9]]
    assert trace.kernel_share({"attn_sm90_kernel<0, 2>(x)": [2.0, 24], "gemm": [1.0, 3]},
                              trace.PORT_KERNELS["K1 mha"]) == (2.0, 24)


class _StubDriver:
    """The search driver's window over buckets that take ``secs`` each."""

    def __init__(self, durations):
        self.durations = list(durations)

    def make(self, m):
        drv = m.driver("search_bucket").Driver(m.cell(CELL), m.config("owlvit-b32"), 0, "cpu", {})
        durations = self.durations

        def bucket(tag):
            time.sleep(durations.pop(0))
            b = {"rows": [{}] * 8, "trace": [], "steps": 2, "grid_images": 16,
                 "verify_widths": [8, 8], "host_reads": 4}
            drv.buckets.append(b)
            return b

        drv.search = type("S", (), {"frames_per_iteration": 16})()
        drv._bucket = bucket
        return drv


def test_window_rate_and_a_stall_lowers_it():
    m = Manifest()
    steady = _StubDriver([0.05] * 6).make(m)
    window = steady.window(0.12)
    assert len(steady.buckets) == 3 and window >= 0.12
    frames = 3 * (16 * 16 + 16)
    assert steady.frames() == frames
    assert steady.end_to_end()["frames_per_s"] == pytest.approx(frames / window)
    stalled = _StubDriver([0.05, 0.2, 0.05, 0.05]).make(m)
    stalled.window(0.12)
    assert stalled.end_to_end()["frames_per_s"] < steady.end_to_end()["frames_per_s"]


def test_readers_read_what_they_find():
    m = Manifest()
    record = {"window_s": 2.0, "busy_s": 1.5,
              "device_ops": {"attn_sm90_kernel<1, 2>": [100.0, 24], "gemm": [400.0, 10]},
              "counters": {"frames": 1000, "steps": 10, "host_reads": 20, "flops": 1e14,
                           "attention_forwards": [{"batch": 8, "seq": 577, "heads": 12,
                                                   "head_dim": 64, "layers": 12, "count": 2}]}}
    read = {mt["name"]: m.reader(mt["name"]).read(record) for mt in m.per_layer(CELL)}
    assert read["device_idle_pct.search"] == pytest.approx(25.0)
    assert read["host_reads_per_step"] == 2.0
    assert read["device_ms_per_frame"] == pytest.approx(0.5)
    assert read["mfu.search"] == pytest.approx(100 * 1e14 / 2.0 / 989e12)
    bound = 24 * flops.attention_launch_bound_s(8, 577, 12, 64)[0]
    assert read["attn_k1_roofline"] == pytest.approx(100 * bound / 0.1)
    # nothing to read: no value, never 0
    empty = {mt["name"]: m.reader(mt["name"]).read({"window_s": 2.0, "busy_s": 0.0})
             for mt in m.per_layer(CELL)}
    assert all(v is None for v in empty.values())
    record["device_ops"]["attn_sm90_kernel<1, 2>"][1] = 23     # launches the count misses
    assert m.reader("attn_k1_roofline").read(record) is None
