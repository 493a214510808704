"""The per-layer metrics that read the program's spans
(``fast_artistic_videos_tpu_torch.utils.profiling``), against a synthetic
window and synthetic spans: the window's filter, the division by frames or
calls, the engine's self time less the stylizer, and nothing to read where
no span is (or where the program records none); and the latency tail of
the frames landed in the window. On the card: one K1 launch is one
``kernel.K1`` span and one count of ``Kernel.launches``."""

import os
import sys
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from fast_artistic_videos_tpu_torch.utils import profiling  # noqa: E402
from portbench.harness import spec  # noqa: E402
from portbench.harness.main import Context  # noqa: E402

MS = 1_000_000
W0, W1 = 1000 * MS, 2000 * MS          # the window
_ids = iter(range(1, 10_000))


def span(name, a_ms, b_ms, parent=None):
    return profiling.Span(name, next(_ids), parent, (0, 1), 7, W0 + a_ms * MS, W0 + b_ms * MS)


def ctx(landed=4):
    return Context(trace=types.SimpleNamespace(bounds=(W0, W1)), landed=landed, process_ms=[],
                   flops_per_frame=0.0, peak_flops=1.0, cards=1)


def read(metric, spans, monkeypatch, landed=4):
    monkeypatch.setattr(profiling, "spans", lambda a=None, b=None: [
        s for s in spans if (a is None or s.start_ns >= a) and (b is None or s.end_ns <= b)])
    return spec.reader(metric)(ctx(landed))


def outside(name):
    """A span that starts before the window and one that ends after it."""
    return [span(name, -5, 3), span(name, 998, 1003)]


def test_driver_wait_sums_both_waits_per_frame(monkeypatch):
    spans = [span("pipeline.prefetch_wait", 0, 6), span("pipeline.writer_wait", 10, 12),
             span("pipeline.prefetch_wait", 20, 22), span("flow", 30, 90)]
    spans += outside("pipeline.prefetch_wait")
    assert read("driver.wait_ms", spans, monkeypatch) == pytest.approx(10 / 4)
    assert read("driver.wait_ms", spans[3:], monkeypatch) is None


def test_frame_latency_p95_is_the_tail_of_the_frames_landed_in_the_window():
    lat = [float(v) for v in range(1, 101)]
    c = Context(trace=types.SimpleNamespace(bounds=(W0, W1)), landed=100, process_ms=[],
                flops_per_frame=0.0, peak_flops=1.0, cards=1, latency_ms=lat)
    read = spec.reader("frame.latency_ms_p95")
    assert read(c) == pytest.approx(95.05)
    assert read(ctx()) is None          # nothing landed


def test_pool_upload_per_process_call(monkeypatch):
    spans = []
    for k in range(3):
        p = span("pool.process", 100 * k, 100 * k + 90)
        spans += [p, span("pool.upload", 100 * k, 100 * k + 5, p.id)]
    spans += [span("pool.upload", 400, 412)] + outside("pool.process")
    assert read("pool.upload_ms", spans, monkeypatch) == pytest.approx((15 + 12) / 3)
    assert read("pool.upload_ms", [s for s in spans if s.name == "pool.upload"],
                monkeypatch) is None


def test_flow_and_stylizer_host_per_frame(monkeypatch):
    f = span("flow", 0, 20)
    spans = [f, span("flow.band_wait", 5, 8, f.id), span("flow", 100, 130),
             span("stylizer", 200, 250), span("stylizer", 300, 340)]
    spans += outside("flow") + outside("stylizer")
    assert read("flow.host_ms", spans, monkeypatch, landed=5) == pytest.approx(50 / 5)
    assert read("stylizer.host_ms", spans, monkeypatch, landed=5) == pytest.approx(90 / 5)
    assert read("flow.host_ms", spans, monkeypatch, landed=0) is None
    assert read("stylizer.host_ms", spans[:3], monkeypatch) is None


def test_engine_host_is_self_time_less_the_stylizer(monkeypatch):
    step = span("engine.step", 0, 100)
    k = span("kernel.K1", 2, 4, step.id)
    prior = span("vr.prior", 200, 230)
    spans = [step, k, span("stylizer", 10, 70, step.id), prior,
             span("kernel.K5", 205, 210, prior.id), span("vr.blend", 300, 306),
             span("vr.outputs", 400, 404), span("stylizer", 500, 600)]
    spans += outside("engine.step")
    # 40 of the step (the kernel's launch stays in it) + 30 + 6 + 4, over 2
    assert read("engine.host_ms", spans, monkeypatch, landed=2) == pytest.approx(80 / 2)
    assert read("engine.host_ms", spans[-3:], monkeypatch) is None


def test_kernels_host_is_the_mean_launch(monkeypatch):
    spans = [span("kernel.K1", 0, 0.010), span("kernel.K2", 1, 1.030),
             span("kernel.K5", 2, 2.020), span("engine.step", 0, 10)] + outside("kernel.K3")
    assert read("kernels.host_us", spans, monkeypatch) == pytest.approx(20.0)
    assert read("kernels.host_us", spans[3:], monkeypatch) is None


@pytest.mark.parametrize("metric", ["driver.wait_ms", "pool.upload_ms", "flow.host_ms",
                                    "engine.host_ms", "stylizer.host_ms", "kernels.host_us"])
def test_nothing_to_read_without_the_programs_spans(metric, monkeypatch):
    """A program without ``profiling.spans`` (before the spans were added)
    reads None and raises nothing."""
    monkeypatch.delattr(profiling, "spans")
    assert spec.reader(metric)(ctx()) is None


@pytest.mark.gpu
def test_one_k1_launch_is_one_span_on_the_card():
    """On the card (``python -m pytest -m gpu portbench/tests``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from fast_artistic_videos_tpu_torch.ops import warp_kernel

    img = torch.rand(1, 64, 96, 3, device="cuda")
    flow = torch.zeros(1, 64, 96, 2, device="cuda")
    warp_kernel.warp_banded(img, flow, 2)        # the library built and loaded
    torch.cuda.synchronize()
    before = warp_kernel.KERNEL.launches
    profiling.clear()
    with profiling.recording():
        warp_kernel.warp_banded(img, flow, 2)
    torch.cuda.synchronize()
    got = profiling.spans()
    assert [s.name for s in got] == ["kernel.K1"]
    assert warp_kernel.KERNEL.launches == before + 1
    profiling.clear()
