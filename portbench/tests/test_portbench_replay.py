"""``flow.replay_share`` against synthetic spans: the flow provider's steps
that replayed their graphs without a capture, over all its steps in the
window, and nothing to read in a program without the graph spans."""

import importlib.util
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


def span(name, a_ms, b_ms, parent=None):
    return profiling.Span(name, next(_ids), parent, (0, 1), 7, W0 + a_ms * MS, W0 + b_ms * MS)


def step(a_ms, *inside):
    """A ``flow`` span at `a_ms` with the spans named in `inside` in it."""
    f = span("flow", a_ms, a_ms + 10)
    return [f] + [span(name, a_ms + 1 + i, a_ms + 2 + i, f.id) for i, name in enumerate(inside)]


def read(spans, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda a=None, b=None: [
        s for s in spans if (a is None or s.start_ns >= a) and (b is None or s.end_ns <= b)])
    ctx = Context(trace=types.SimpleNamespace(bounds=(W0, W1)), landed=4, process_ms=[],
                  flops_per_frame=0.0, peak_flops=1.0, cards=1)
    return spec.reader("flow.replay_share")(ctx)


def test_replay_share_counts_steps_that_replayed_without_a_capture(monkeypatch):
    spans = (step(0)                                                # a first frame, eager
             + step(20, "flow.band_wait")                           # a first pair, eager
             + step(40, "flow.capture", "flow.replay", "flow.band_wait",
                    "flow.capture", "flow.replay")                  # both parts captured
             + step(60, "flow.replay", "flow.band_wait", "flow.capture",
                    "flow.replay")                                  # a new band
             + step(80, "flow.replay", "flow.band_wait", "flow.replay")
             + step(100, "flow.replay", "flow.band_wait", "flow.replay")
             + step(120, "flow.replay"))                            # a first frame, replayed
    # a step that ends after the window, and graph spans outside any step
    spans += step(995, "flow.replay", "flow.replay") + [span("flow.replay", 200, 201)]
    assert read(spans, monkeypatch) == pytest.approx(100.0 * 3 / 7)
    assert read([s for s in spans if s.name != "flow"], monkeypatch) is None


def test_replay_share_reads_nothing_without_the_graph_spans(monkeypatch):
    """A program without the graphs' module (before the graphs were added)
    or without the span buffer reads None and raises nothing."""
    spans = step(0) + step(20, "flow.band_wait")
    reader = spec.reader("flow.replay_share")
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name.endswith("flow.graphs") else real(name, *a))
    assert read(spans, monkeypatch) is None
    monkeypatch.undo()
    assert read(spans, monkeypatch) == 0.0
    monkeypatch.delattr(profiling, "spans")
    ctx = Context(trace=types.SimpleNamespace(bounds=(W0, W1)), landed=4, process_ms=[],
                  flops_per_frame=0.0, peak_flops=1.0, cards=1)
    assert reader(ctx) is None
