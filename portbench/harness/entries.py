"""The program's entries that a traffic mix can drive, each as a closed
loop over a window: the stylize CLI's loop (``VideoDriver.run``), the 360°
CLI's loop (``VRDriver.run``) and the serving pool
(``StreamPool.process``). Each builds the program from the options a user
passes, warms up every shape the window uses on the same frames, starts
the clips afresh, and hands frames to the program as host uint8 arrays
until the window closes; then it lets the frames in flight land.

A frame's latency runs from the moment its content is handed to the
program (the driver's loader call, the pool's ``process`` call) to the
moment its uint8 frame is in host memory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import tracing

FRAME_CAP_FPS = 1000      # frames a second the drivers' index lists allow for


@dataclasses.dataclass
class Landing:
    stream: int
    index: int
    submitted: float
    landed: Optional[float] = None


class Record:
    """Submissions and landings of one run, stamped on the host clock.
    The window opens at the first submission after ``arm`` and closes
    `seconds` later."""

    def __init__(self, seconds: float, keep_output, keep_state):
        self.seconds = seconds
        self.keep_output = keep_output      # (stream, index) -> keep its uint8 frame?
        self.keep_state = keep_state        # (stream, index) -> keep its carried state?
        self.frames: Dict[tuple, Landing] = {}
        self.outputs: Dict[tuple, np.ndarray] = {}
        self.states: Dict[tuple, object] = {}
        self.t0 = None
        self.armed = False
        self.errors: List[str] = []
        self._lock = threading.Lock()
        self.on_open = self.on_close = None
        self._closed = False
        self.closed_at = None

    def arm(self):
        self.frames.clear()
        self.outputs.clear()
        self.states.clear()
        self.t0, self.armed, self._closed, self.closed_at = None, True, False, None

    def is_open(self) -> bool:
        """Whether a frame may be submitted now; closes the window when its
        time is up."""
        if not self.armed:
            return True
        if self.t0 is None:
            return True
        if time.monotonic() - self.t0 < self.seconds:
            return True
        if not self._closed:
            self._closed = True
            self.closed_at = time.monotonic()
            if self.on_close:
                self.on_close()
        return False

    def submit(self, stream: int, index: int):
        now = time.monotonic()
        if self.armed and self.t0 is None:
            self.t0 = now
            if self.on_open:
                self.on_open()
        with self._lock:
            self.frames[(stream, index)] = Landing(stream, index, now)

    def land(self, stream: int, index: int, u8=None):
        now = time.monotonic()
        with self._lock:
            rec = self.frames.get((stream, index))
            if rec is None:
                self.errors.append(f"stream {stream} frame {index} landed unsubmitted")
                return
            rec.landed = now
            if u8 is not None and self.keep_output(stream, index):
                self.outputs[(stream, index)] = np.array(u8, copy=True)

    def carry(self, stream: int, index: int, state):
        """The program's carried state after a frame (device tensors, held
        as they are: the program makes new ones each frame)."""
        if self.keep_state(stream, index):
            self.states[(stream, index)] = state

    @property
    def t1(self):
        return None if self.t0 is None else self.t0 + self.seconds


@dataclasses.dataclass
class Job:
    """What an entry needs: the cell's configuration and traffic, its
    seed's frames, the checkpoints for the program (the stylizer's, and
    the flow's with its family's reader of the pool's ``flow_params``),
    the devices and whether this run is traced."""
    config: dict
    traffic: dict
    pans: list
    checkpoint: str
    flow_weights: str
    flow_params: Callable
    devices: List[torch.device]
    dtype: str
    trace: bool
    record: Record
    launches: Optional[tracing.Launches] = None
    profile: Optional[object] = None
    process_ms: List[float] = dataclasses.field(default_factory=list)


@contextlib.contextmanager
def traced_window(job: Job):
    """While the window of a traced run is open: the profiler on, the
    kernels' launches recorded and the window span open on the thread that
    opens it. The profiler stops once the frames in flight have landed."""
    if not job.trace:
        yield
        return
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA],
                                  experimental_config=tracing.all_threads())
    span = torch.profiler.record_function(tracing.WINDOW)
    rec = job.record

    def opened():
        span.__enter__()

    def closed():
        span.__exit__(None, None, None)

    rec.on_open, rec.on_close = opened, closed
    prof.__enter__()
    try:
        with job.launches.recording():
            yield
        sync(job.devices)
    finally:
        prof.__exit__(None, None, None)
        rec.on_open = rec.on_close = None
    job.profile = prof


def settle(devices):
    """After the warm-up: wait for the cards, and move what set-up made
    out of the collector's way, so that the window does not pay for
    collecting it."""
    sync(devices)
    gc.collect()
    gc.freeze()


def sync(devices):
    """Wait for every card of `devices` (a CPU device has nothing to wait for)."""
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _u8_frame(pan, t: int) -> np.ndarray:
    return np.ascontiguousarray(pan.frame(t))


# ---------------------------------------------------------------------------
# the 2D driver (cli/stylize_video.py's loop)
# ---------------------------------------------------------------------------

def video_driver(job: Job):
    from fast_artistic_videos_tpu_torch.cli import stylize_video as cli
    from fast_artistic_videos_tpu_torch.core.config import StylizeOptions
    from fast_artistic_videos_tpu_torch.video.driver_video import VideoDriver

    cfg, tr, rec = job.config, job.traffic, job.record
    pan = job.pans[0]
    opt = StylizeOptions(model_vid=job.checkpoint, flow_model=job.flow_weights,
                         flow_scale=float(cfg["flow"]["scale"]), dtype=job.dtype,
                         occlusions_min_filter=int(cfg["occlusions_min_filter"]),
                         input_pattern="memory-%05d", output_prefix="memory",
                         num_frames=int(FRAME_CAP_FPS * rec.seconds) + 10)
    device = job.devices[0]
    engine = cli.build_engine(opt, device)
    provider = cli.build_flow_provider(opt, device)
    if job.trace:
        engine.apply_vid = tracing.spanned(engine.apply_vid, tracing.STYLIZER)
        provider = tracing.SpannedProvider(provider)
    steps = [0]

    def carried(fn):
        # the stylized frame a step returns is the state the next step reads
        def step(*args, **kwargs):
            out = fn(*args, **kwargs)
            rec.carry(0, steps[0], out[0] if isinstance(out, tuple) else out)
            steps[0] += 1
            return out
        return step

    engine.stylize_first = carried(engine.stylize_first)
    engine.stylize_next = carried(engine.stylize_next)

    class Clip(VideoDriver):
        """Frames from memory, outputs to memory: the driver's two I/O
        methods, and nothing else, replaced."""

        limit = None
        saved = 0

        def load_frame_device(self, i):
            if (self.limit is not None and i > self.limit) or not rec.is_open():
                return None
            frame = _u8_frame(pan, i - 1)
            rec.submit(0, i - 1)
            return torch.from_numpy(frame).to(self.engine.device)

        def save(self, path, u8):
            rec.land(0, self.saved, u8)
            self.saved += 1

    def run(limit):
        driver = Clip(engine, opt, flow_provider=provider)
        driver.limit = limit
        steps[0] = 0
        provider.reset()
        driver.run(progress=False)
        return driver

    rec.armed = False
    run(int(tr["warmup_frames"]))
    settle([device])
    rec.arm()
    with traced_window(job):
        run(None)
    return {"engine": engine, "provider": provider}


# ---------------------------------------------------------------------------
# the 360° driver (cli/stylize_vr_video.py's loop)
# ---------------------------------------------------------------------------

def vr_driver(job: Job):
    from fast_artistic_videos_tpu_torch.cli import stylize_vr_video as cli
    from fast_artistic_videos_tpu_torch.cli.stylize_video import build_engine
    from fast_artistic_videos_tpu_torch.video.driver_vr import VRDriver, VROptions

    cfg, tr, rec = job.config, job.traffic, job.record
    geo = cfg["geometry"]
    opt = VROptions(model_vid=job.checkpoint, flow_model=job.flow_weights,
                    flow_scale=float(cfg["flow"]["scale"]), dtype=job.dtype,
                    occlusions_min_filter=int(cfg["occlusions_min_filter"]),
                    input_pattern="memory-%05d-%d", output_prefix="vr",
                    overlap_pixel_w=int(geo["overlap"]), overlap_pixel_h=int(geo["overlap"]),
                    num_frames=int(FRAME_CAP_FPS * rec.seconds) + 10)
    device = job.devices[0]
    engine = build_engine(opt, device)
    provider = cli.build_flow_provider(opt, device)
    if job.trace:
        engine.apply_vid = tracing.spanned(engine.apply_vid, tracing.STYLIZER)
        provider = tracing.SpannedProvider(provider)
    served = []
    sink = []

    class Clip(VRDriver):
        """Faces from memory, outputs to memory: the loader of a frame's
        six faces and the sink, and nothing else, replaced."""

        limit = None

        def _load_frame_faces(self, i):
            k = (i - 1) // 6
            if (self.limit is not None and k >= self.limit) or not rec.is_open():
                return None
            faces = np.stack([_u8_frame(p, k) for p in job.pans])
            rec.submit(0, k)
            served.append(k)
            return self._upload(faces)

        def blend_other_sides(self):
            # the six blended faces are the state the next frame reads
            faces = super().blend_other_sides()
            rec.carry(0, self.blended, faces)
            self.blended += 1
            return faces

        def save(self, path, u8):
            sink.append((path, u8))
            if len(sink) == 6:
                k = len(self.landed)
                self.landed.append(k)
                want = [f"vr{k + 1}_{pos}.png" for pos in range(6)]
                if [p for p, _ in sink] != want:
                    rec.errors.append(f"the sink received {[p for p, _ in sink]} for frame {k}")
                rec.land(0, k, np.stack([f for _, f in sink]))
                sink.clear()

    geometry = []

    def run(limit):
        served.clear()
        driver = Clip(engine, opt, batched_flow_provider=provider)
        driver.limit, driver.landed, driver.blended = limit, [], 0
        if geometry:
            # the face geometry (maps, strip tables, masks) of the warm-up's
            # clip: static for the face size, so the window holds frames only
            driver.geo = geometry[0]
        provider.reset()
        driver.run(progress=False)
        if driver.landed != served or sink:
            rec.errors.append(f"served frames {len(served)}, landed {len(driver.landed)}")
        if not geometry:
            geometry.append(driver.geo)
        return driver

    rec.armed = False
    run(int(tr["warmup_frames"]))
    settle([device])
    rec.arm()
    with traced_window(job):
        run(None)
    return {"engine": engine, "provider": provider}


# ---------------------------------------------------------------------------
# the serving pool (video/serving.py)
# ---------------------------------------------------------------------------

class _Watcher(threading.Thread):
    """Waits, in submission order, for one card's copies to host memory
    and stamps each frame's landing; `landed[stream]` counts a stream's
    landed frames."""

    def __init__(self, rec: Record, cond: threading.Condition, landed: List[int]):
        super().__init__(daemon=True)
        self.q: queue.Queue = queue.Queue()
        self.rec, self.cond, self.landed = rec, cond, landed
        self.error = None

    def run(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            ev, s, t, buf = item
            try:
                if ev is not None:
                    ev.synchronize()
                self.rec.land(s, t, buf.numpy())
            except Exception as e:          # reported by the main thread
                self.error = e
            with self.cond:
                self.landed[s] += 1
                self.cond.notify_all()


def stream_pool(job: Job):
    from fast_artistic_videos_tpu_torch.models import checkpoint
    from fast_artistic_videos_tpu_torch.video.engine import quantize_u8
    from fast_artistic_videos_tpu_torch.video.serving import StreamPool

    cfg, tr, rec = job.config, job.traffic, job.record
    n = int(tr["streams"])
    in_flight = int(tr["in_flight"])
    spec, params, _ = checkpoint.load_model(job.checkpoint, job.devices[0])
    pool = StreamPool(spec, params,
                      flow_params=job.flow_params(job.flow_weights, job.devices[0]),
                      n_streams=n, devices=job.devices, dtype=job.dtype,
                      flow_scale=float(cfg["flow"]["scale"]))
    process = pool.process
    if job.trace:
        for dev, eng in pool._engines.items():
            eng.apply_vid = tracing.spanned(eng.apply_vid, tracing.STYLIZER)
        pool._providers = [tracing.SpannedProvider(p) if p is not None else None
                           for p in pool._providers]
        process = tracing.spanned(pool.process, tracing.POOL)
    h, w = job.pans[0].h, job.pans[0].w
    ring = in_flight + 1
    pinned = all(d.type == "cuda" for d in job.devices)
    bufs = [[torch.empty((h, w, 3), dtype=torch.uint8, pin_memory=pinned) for _ in range(ring)]
            for _ in range(n)]
    cond = threading.Condition()

    def loop(limit):
        landed = [0] * n
        watchers = {d: _Watcher(rec, cond, landed) for d in dict.fromkeys(pool._stream_dev)}
        for wt in watchers.values():
            wt.start()
        t = [0] * n
        try:
            running = True
            while running:
                for s in range(n):
                    if limit is not None and t[s] >= limit:
                        running = False
                        break
                    with cond:
                        while landed[s] < t[s] - in_flight + 1:
                            cond.wait()
                    if not rec.is_open():
                        running = False
                        break
                    frame = _u8_frame(job.pans[s], t[s])
                    rec.submit(s, t[s])
                    t_call = time.monotonic()
                    out = process(s, frame)
                    rec.carry(s, t[s], out)
                    job.process_ms.append((t_call, (time.monotonic() - t_call) * 1e3))
                    dev = pool.device_of(s)
                    buf = bufs[s][t[s] % ring]
                    ev = None
                    if dev.type == "cuda":
                        buf.copy_(quantize_u8(out), non_blocking=True)
                        ev = torch.cuda.Event()
                        ev.record(torch.cuda.current_stream(dev))
                    else:
                        buf.copy_(quantize_u8(out))
                    watchers[dev].q.put((ev, s, t[s], buf))
                    t[s] += 1
        finally:
            for wt in watchers.values():
                wt.q.put(None)
            for wt in watchers.values():
                wt.join()
        for wt in watchers.values():
            if wt.error is not None:
                raise wt.error

    rec.armed = False
    loop(int(tr["warmup_frames"]))
    for s in range(n):
        pool.reset(s)
    settle(job.devices)
    job.process_ms.clear()
    rec.arm()
    with traced_window(job):
        loop(None)
    return {"pool": pool}


ENTRIES = {"video_driver": video_driver, "vr_driver": vr_driver, "stream_pool": stream_pool}


def run_dir() -> str:
    """A directory of this run's own under TMPDIR."""
    import tempfile

    return tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR"))
