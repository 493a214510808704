"""The port's spans (fast_artistic_videos_tpu_torch.utils.profiling) on the
CPU: the off path, nesting, keys and threads under ``recording()``, the
clock against torch.profiler's events, the readers, and the spans a tiny
2D clip, 360-degree clip and serving pool record per frame (the demo
model and the bundled flow estimator, float32, 48-px frames)."""

import collections
import threading
import time

import numpy as np
import pytest
import torch

from fast_artistic_videos_tpu_torch.cli import stylize_video as cli
from fast_artistic_videos_tpu_torch.cli import stylize_vr_video as vr_cli
from fast_artistic_videos_tpu_torch.core.config import StylizeOptions
from fast_artistic_videos_tpu_torch.flow import estimator as flow_estimator
from fast_artistic_videos_tpu_torch.models import checkpoint
from fast_artistic_videos_tpu_torch.utils import profiling
from fast_artistic_videos_tpu_torch.video.driver_video import VideoDriver
from fast_artistic_videos_tpu_torch.video.driver_vr import VRDriver, VROptions
from fast_artistic_videos_tpu_torch.video.serving import StreamPool

H, W, FRAMES = 48, 64, 4
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh():
    """One torch thread (the suite runs several workers on the host's
    cores) and an empty span buffer around each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.clear()
    try:
        yield
    finally:
        profiling.clear()
        torch.set_num_threads(n)


def pan(seed, n, h, w):
    """n frames of a seeded uint8 image panning 2 px a frame."""
    base = np.random.default_rng(seed).integers(0, 256, (h, w + 2 * n, 3), dtype=np.uint8)
    return [np.ascontiguousarray(base[:, 2 * t:2 * t + w]) for t in range(n)]


def by_name(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[s.name].append(s)
    return out


def parent_names(spans):
    ids = {s.id: s.name for s in spans}
    return {(s.name, ids.get(s.parent)) for s in spans}


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range {name!r} opened with tracing off")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("a") is profiling.span("b")
    assert profiling.keyed(0, 1) is profiling.span("a")
    with profiling.keyed(0, 1), profiling.span("a"):
        with profiling.span("b"):
            pass
    assert profiling.traced("c")(lambda x: x + 1)(1) == 2
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_recording_nests_spans_with_parent_key_and_thread():
    seen = {}

    def worker():
        with profiling.keyed(2, 5), profiling.span("thread"):
            seen["ident"] = threading.get_ident()

    with profiling.recording():
        with profiling.keyed(3, 7):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    t = threading.Thread(target=worker)
                    t.start()
                    t.join(timeout=30)
                    assert not t.is_alive()
            with profiling.span("after"):
                pass
        with profiling.span("unkeyed"):
            pass
    with profiling.span("outside"):
        pass
    s = {x.name: x for x in profiling.spans()}
    assert set(s) == {"outer", "inner", "thread", "after", "unkeyed"}
    assert s["outer"].parent is None and s["inner"].parent == s["outer"].id
    assert s["after"].parent is None and s["thread"].parent is None
    assert s["outer"].key == s["inner"].key == s["after"].key == (3, 7)
    assert s["thread"].key == (2, 5) and s["unkeyed"].key is None
    assert s["thread"].thread == seen["ident"] != s["outer"].thread == threading.get_ident()
    assert len({x.id for x in s.values()}) == 5
    for x in s.values():
        assert x.start_ns <= x.end_ns
    assert s["outer"].start_ns <= s["inner"].start_ns <= s["inner"].end_ns <= s["outer"].end_ns


@pytest.mark.parametrize("all_threads", [False, True])
def test_spans_line_up_with_their_profiler_events(all_threads):
    """Each span is a host range of its name in the profile (a cpu_op, not
    a user annotation, which the profiler would copy onto the card's
    timeline), started within 1 ms of its recorded start, on the main
    thread and on another, also under the profiler's every-thread option
    (whose runs leave the per-thread C flag off)."""
    from torch._C._profiler import _ExperimentalConfig

    cfg = _ExperimentalConfig(profile_all_threads=True) if all_threads else None

    def worker():
        with profiling.span("probe.thread"):
            torch.ones(8).sum()

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                experimental_config=cfg) as prof:
        with profiling.span("probe.main"):
            torch.ones(8).sum()
        if all_threads:
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    mine = {s.name: s for s in profiling.spans()}
    want = {"probe.main", "probe.thread"} if all_threads else {"probe.main"}
    assert set(mine) == want
    events = {ev.name(): ev for ev in prof.profiler.kineto_results.events()
              if ev.name() in want}
    assert set(events) == want
    for name in want:
        assert not events[name].is_user_annotation()
        assert abs(events[name].start_ns() - mine[name].start_ns) < 1_000_000
        assert abs(events[name].end_ns() - mine[name].end_ns) < 1_000_000


def _span(name, sid, parent, a, b):
    return profiling.Span(name, sid, parent, None, 1, a, b)


def test_window_self_time_and_bounded_buffer(monkeypatch):
    # engine.step [0, 100] holding stylizer [10, 40] and [30, 60] (overlap
    # counted once) and a kernel [70, 80] holding a stylizer [72, 75]; a
    # second step [200, 250] with none
    among = [_span("engine.step", 1, None, 0, 100), _span("stylizer", 2, 1, 10, 40),
             _span("stylizer", 3, 1, 30, 60), _span("kernel.K1", 4, 1, 70, 80),
             _span("stylizer", 5, 4, 72, 75), _span("engine.step", 6, None, 200, 250),
             _span("stylizer", 7, None, 300, 310)]
    assert profiling.self_ns(among, {"engine.step"}, {"stylizer"}) == (100 - 50 - 3) + 50
    assert profiling.self_ns(among, {"engine.step"}) == 150
    # the stylizer inside the kernel counts for the kernel alone
    assert profiling.self_ns(among, {"engine.step", "kernel.K1"}, {"stylizer"}) == 50 + 7 + 50
    assert profiling.self_ns(among, {"vr.blend"}, {"stylizer"}) == 0

    monkeypatch.setattr(profiling, "_BUFFER", collections.deque(maxlen=3))
    with profiling.recording():
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
            time.sleep(0.002)
    got = profiling.spans()
    assert [s.name for s in got] == ["s2", "s3", "s4"] and profiling.dropped() == 2
    assert [s.name for s in profiling.spans(got[1].start_ns, got[1].end_ns)] == ["s3"]
    assert [s.name for s in profiling.spans(got[1].start_ns)] == ["s3", "s4"]
    assert [s.name for s in profiling.spans(None, got[1].end_ns)] == ["s2", "s3"]
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_traced_keeps_the_function():
    @profiling.traced("named")
    def add(a, b=1):
        """Adds."""
        return a + b

    with profiling.recording():
        assert add(1, b=2) == 3
        with pytest.raises(TypeError):
            add()
    assert add.__name__ == "add" and add.__doc__ == "Adds."
    assert [s.name for s in profiling.spans()] == ["named", "named"]


def _options(**kw):
    return dict(model_vid="demo", flow_model="bundled", flow_scale=0.5, dtype="float32",
                occlusions_min_filter=3, **kw)


def test_video_driver_spans_per_frame():
    frames = pan(1, FRAMES, H, W)
    opt = StylizeOptions(**_options(input_pattern="memory-%05d", output_prefix="memory",
                                    num_frames=FRAMES))
    engine = cli.build_engine(opt, CPU)
    provider = cli.build_flow_provider(opt, CPU)
    saved = []

    class Clip(VideoDriver):
        def load_frame_device(self, i):
            return torch.from_numpy(frames[i - 1])

        def save(self, path, u8):
            saved.append(path)

    loop = threading.get_ident()
    with profiling.recording():
        Clip(engine, opt, flow_provider=provider).run(progress=False)
    assert len(saved) == FRAMES
    got = profiling.spans()
    n = by_name(got)
    assert {k: len(v) for k, v in n.items()} == {
        "flow": FRAMES, "flow.band_wait": FRAMES - 2, "engine.step": FRAMES,
        "stylizer": FRAMES, "pipeline.prefetch_wait": FRAMES + 1,
        "pipeline.writer_wait": FRAMES}
    assert parent_names(got) == {
        ("flow", None), ("flow.band_wait", "flow"), ("engine.step", None),
        ("stylizer", "engine.step"), ("pipeline.prefetch_wait", None),
        ("pipeline.writer_wait", None)}
    # flow on the prefetch thread, the rest on the loop's; each frame's
    # spans keyed (0, frame) on both
    assert {s.thread for s in n["flow"]} != {loop}
    assert all(s.thread == loop for k in ("engine.step", "stylizer", "pipeline.writer_wait")
               for s in n[k])
    for k in ("flow", "engine.step", "stylizer", "pipeline.writer_wait"):
        assert sorted(s.key for s in n[k]) == [(0, i) for i in range(1, FRAMES + 1)]
    assert sorted(s.key for s in n["flow.band_wait"]) == [(0, i) for i in range(3, FRAMES + 1)]
    # the loop's wait for frame i is keyed (0, i); the last wait, for the
    # end of the clip, belongs to no frame
    waits = sorted(n["pipeline.prefetch_wait"], key=lambda s: s.start_ns)
    assert all(s.thread == loop for s in waits)
    assert [s.key for s in waits] == [(0, i) for i in range(1, FRAMES + 1)] + [None]


def test_vr_driver_spans_per_frame():
    n_frames, face = 3, 48
    pans = [pan(10 + p, n_frames, face, face) for p in range(6)]
    opt = VROptions(**_options(input_pattern="memory-%05d-%d", output_prefix="vr",
                               overlap_pixel_w=16, overlap_pixel_h=16, num_frames=n_frames))
    engine = cli.build_engine(opt, CPU)
    provider = vr_cli.build_flow_provider(opt, CPU)
    saved = []

    class Clip(VRDriver):
        def _load_frame_faces(self, i):
            k = (i - 1) // 6
            return self._upload(np.stack([p[k] for p in pans]))

        def save(self, path, u8):
            saved.append(path)

    with profiling.recording():
        assert Clip(engine, opt, batched_flow_provider=provider).run(progress=False) == 18
    assert len(saved) == 18
    got = profiling.spans()
    n = by_name(got)
    assert {k: len(v) for k, v in n.items()} == {
        "flow": n_frames, "flow.band_wait": n_frames - 2, "engine.step": 6 * n_frames,
        "stylizer": 6 * n_frames, "vr.prior": 6 * n_frames - 1, "vr.blend": n_frames,
        "vr.outputs": n_frames, "pipeline.prefetch_wait": n_frames,
        "pipeline.writer_wait": n_frames}
    assert parent_names(got) == {
        ("flow", None), ("flow.band_wait", "flow"), ("engine.step", None),
        ("stylizer", "engine.step"), ("vr.prior", None), ("vr.blend", None),
        ("vr.outputs", None), ("pipeline.prefetch_wait", None), ("pipeline.writer_wait", None)}
    per_frame = collections.Counter((s.name, s.key) for s in got)
    for k in range(1, n_frames + 1):
        assert per_frame[("flow", (0, k))] == per_frame[("vr.blend", (0, k))] == 1
        assert per_frame[("engine.step", (0, k))] == per_frame[("stylizer", (0, k))] == 6
        assert per_frame[("vr.prior", (0, k))] == (5 if k == 1 else 6)
        assert per_frame[("pipeline.prefetch_wait", (0, k))] == 1
    assert len({s.thread for s in got}) == 1


def test_pool_spans_per_frame():
    spec, params, _ = checkpoint.load_model("demo", device="cpu")
    pool = StreamPool(spec, params, flow_params=flow_estimator.load_params("bundled", "cpu"),
                      n_streams=2, devices=["cpu", "cpu"], dtype="float32", flow_scale=0.5)
    clips = [pan(20 + s, 3, H, W) for s in range(2)]
    feed = [(s, t) for t in range(3) for s in range(2)]
    with profiling.recording():
        for s, t in feed:
            pool.process(s, clips[s][t])
        pool.reset(1)
        pool.process(1, clips[1][0])
        flow = np.zeros((H, W, 2), np.float32)
        cert = np.ones((H, W), np.float32)
        pool.process(1, clips[1][1], (flow, cert))
    got = profiling.spans()
    n = by_name(got)
    calls = len(feed) + 2
    assert {k: len(v) for k, v in n.items()} == {
        "pool.process": calls, "pool.upload": calls + 2, "flow": calls - 1,
        "flow.band_wait": 2, "engine.step": calls, "stylizer": calls}
    assert parent_names(got) == {
        ("pool.process", None), ("pool.upload", "pool.process"), ("flow", "pool.process"),
        ("flow.band_wait", "flow"), ("engine.step", "pool.process"),
        ("stylizer", "engine.step")}
    # the key: (stream, frames since the stream's reset)
    assert [s.key for s in sorted(n["pool.process"], key=lambda s: s.start_ns)] == (
        feed + [(1, 0), (1, 1)])
    for s in got:
        assert s.key is not None
    assert collections.Counter(s.key for s in n["pool.upload"])[(1, 1)] == 4
