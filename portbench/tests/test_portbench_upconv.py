"""The per-layer metrics of K6, the folded upsample conv, against a
synthetic trace and synthetic spans: its device time per frame from the
kernel's symbol inside the window, its launches per stylizer call from the
``kernel.K6`` spans inside ``stylizer`` spans, and nothing to read where
the program launched no K6 (as before K6 existed) or records no span."""

import os
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from fast_artistic_videos_tpu_torch.utils import profiling  # noqa: E402
from portbench.harness import spec  # noqa: E402
from portbench.harness.main import Context  # noqa: E402

MS = 1_000_000
W0, W1 = 1000 * MS, 2000 * MS          # the window
_ids = iter(range(1, 10_000))

K6 = "void (anonymous namespace)::upconv_f32_kernel<(anonymous namespace)::K9Cfg>(UpconvArgs)"


def ctx(events=(), landed=4):
    trace = types.SimpleNamespace(bounds=(W0, W1), events=list(events))
    return Context(trace=trace, landed=landed, process_ms=[], flops_per_frame=0.0,
                   peak_flops=1.0, cards=1)


def event(name, a_ms, b_ms):
    return (name, 0, W0 + a_ms * MS, W0 + b_ms * MS, "stylizer")


def span(name, a_ms, b_ms, parent=None):
    return profiling.Span(name, next(_ids), parent, (0, 1), 7, W0 + a_ms * MS, W0 + b_ms * MS)


def test_device_ms_per_frame_inside_the_window():
    events = [event(K6, 0, 1), event(K6, 10, 10.5), event("conv3x3_f32_kernel", 2, 9),
              event(K6, -3, -1), event(K6, 1001, 1002)]
    read = spec.reader("upsample_conv.device_ms")
    assert read(ctx(events, landed=3)) == pytest.approx(1.5 / 3)
    assert read(ctx(events[2:3])) is None
    assert read(ctx(events, landed=0)) is None


def _calls(n, k6_each):
    spans = []
    for c in range(n):
        s = span("stylizer", 100 * c, 100 * c + 50)
        inner = span("kernel.K2", 100 * c + 1, 100 * c + 2, s.id)
        spans += [s, inner]
        spans += [span("kernel.K6", 100 * c + 10 + j, 100 * c + 11 + j, s.id)
                  for j in range(k6_each)]
    return spans


def test_launches_per_stylizer_call(monkeypatch):
    spans = _calls(3, 2) + [span("kernel.K6", 900, 901)]      # outside any stylizer span
    spans += [span("stylizer", -10, 5), span("kernel.K6", 995, 1005)]   # across the edges
    monkeypatch.setattr(profiling, "spans", lambda a=None, b=None: [
        s for s in spans if (a is None or s.start_ns >= a) and (b is None or s.end_ns <= b)])
    assert spec.reader("upsample_conv.launches")(ctx()) == pytest.approx(2.0)


def test_nothing_to_read_without_k6(monkeypatch):
    spans = _calls(3, 0)
    monkeypatch.setattr(profiling, "spans", lambda a=None, b=None: spans)
    assert spec.reader("upsample_conv.launches")(ctx()) is None
    monkeypatch.delattr(profiling, "spans")
    assert spec.reader("upsample_conv.launches")(ctx()) is None
