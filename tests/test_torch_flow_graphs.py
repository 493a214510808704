"""The streaming flow providers' graph path (flow/graphs.py) on the CPU.

A provider on the CPU takes the eager step and no graph: it opens no
``flow.capture`` or ``flow.replay`` span, makes no graphs, and its outputs
are the composition of the estimator and the consistency check that the
step is. The graph path's own bookkeeping (static inputs, parts by key,
outputs copied out, providers sharing one estimator's graphs, a band met
later, a restarted stream) is held here with a stand-in for the CUDA
graph that runs the captured function again at each replay; the card's
tests (``tests/test_torch_kernels_gpu.py``) hold real graphs against eager
steps bit for bit."""

import collections
import contextlib
import gc
import sys
import types

import numpy as np
import pytest
import torch
from torch.utils import _pytree

from fast_artistic_videos_tpu_torch.flow import consistency
from fast_artistic_videos_tpu_torch.flow import estimator as flow_estimator
from fast_artistic_videos_tpu_torch.flow import graphs as step_graphs
from fast_artistic_videos_tpu_torch.flow import provider as provider_mod
from fast_artistic_videos_tpu_torch.ops.warp import flow_band
from fast_artistic_videos_tpu_torch.utils import profiling

H, W = 64, 96
# at flow scale 0.5 the 24-px steps are 12 px of flow: past the smallest
# band bucket of 8, and back
STEPS = (2, 2, 2, 24, 24, 24, 2, 2)


@pytest.fixture(scope="module")
def params():
    return flow_estimator.load_params("bundled", "cpu")


@pytest.fixture
def est(params):
    """An estimator of its own (graphs are shared by estimator), on one
    torch thread (the suite runs several workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield flow_estimator.FlowEstimator(params, device="cpu")
    finally:
        torch.set_num_threads(n)


def pan(seed, h=H, w=W):
    base = np.random.default_rng(seed).integers(0, 256, (h + 8, w + sum(STEPS), 3),
                                                dtype=np.uint8)
    xs = np.cumsum((0,) + STEPS)
    return [torch.from_numpy(np.ascontiguousarray(base[4:4 + h, x:x + w])) for x in xs]


def tensors(out):
    if out is None:
        return []
    return [t for pair in out for t in pair] if isinstance(out, list) else list(out)


def test_cpu_provider_takes_no_graph_and_keeps_its_outputs(est):
    frames = pan(1)
    p = provider_mod.StreamingFlowProvider(flow_estimator=est, flow_scale=0.5, erode_window=7)
    profiling.clear()
    with profiling.recording():
        outs = [p(f) for f in frames]
        batched = provider_mod.BatchedStreamingFlowProvider(flow_estimator=est,
                                                            flow_scale=0.5)
        for t in range(3):
            batched(torch.stack([frames[t]] * 2).float() / 255.0)
    names = collections.Counter(s.name for s in profiling.spans())
    profiling.clear()
    assert names["flow"] == len(frames) + 3
    assert names["flow.capture"] == names["flow.replay"] == 0
    assert est not in step_graphs._SHARED
    assert outs[0] is None
    # the step: both flows of the pair, the band from the previous pair's
    # signal (the first pair's own maximum), the check at twice the bucket
    hw = (H, W)
    pending = None
    for t in range(1, len(frames)):
        backward, bwd_low, fwd_low, maxabs = est.refine_pair(
            est.prep(frames[t], 0.5), est.prep(frames[t - 1], 0.5), hw, 0.5, with_lowres=True)
        warp_low = flow_band(float(maxabs) if pending is None else pending)
        engine_band = flow_band(warp_low / 0.5)
        cert, rel_max = consistency.consistency_mask_streaming(
            bwd_low, fwd_low, frames[t], out_hw=hw, band=2 * warp_low, erode_window=7,
            warp_limit=engine_band * bwd_low.shape[0] / H, with_rel_maxabs=True)
        pending = float(rel_max)
        assert torch.equal(outs[t][0], backward)
        assert torch.equal(outs[t][1], cert)


class _StandIn:
    """A part's stand-in: each replay runs the captured function again and
    writes its results into the outputs of the capture."""

    def __init__(self, fn, outputs):
        self.fn, self.outputs = fn, outputs

    def __call__(self):
        for dst, src in zip(_pytree.tree_leaves(self.outputs),
                            _pytree.tree_leaves(self.fn())):
            dst.copy_(src)


@pytest.fixture
def stand_in(monkeypatch):
    """The graph path on the CPU: graphs keyed as on a card, captured by
    the stand-in, and the late band signal copied at once (on a card it
    goes to pinned memory before the graphs' next use)."""

    def capture(self, fn):
        outputs = fn()
        return step_graphs._Part((_StandIn(fn, outputs),), outputs)

    @contextlib.contextmanager
    def use(self):
        with self._lock:
            yield self

    def graphs(self, frames):
        key = (type(self).__name__, "cpu", tuple(frames.shape), frames.dtype,
               self.flow_scale) + self._settings()
        return step_graphs.shared(self.estimator, key, torch.device("cpu"))

    late = provider_mod._LateScalar.__init__
    monkeypatch.setattr(step_graphs.StepGraphs, "_capture", capture)
    monkeypatch.setattr(step_graphs.StepGraphs, "use", use)
    monkeypatch.setattr(provider_mod._LateScalar, "__init__",
                        lambda self, t: late(self, t.clone()))
    return graphs


def run(make, clips, restart=2):
    """Each clip through its provider, interleaved, then provider 0
    restarted: every output, a copy of each taken when it was returned,
    the engine bands and the span names."""
    providers = make()
    outs, copies, bands = [], [], []
    feed = [(p, c[t]) for t in range(len(clips[0])) for p, c in zip(providers, clips)]
    profiling.clear()
    with profiling.recording():
        for i, (p, frame) in enumerate(feed + [(None, f) for f in clips[0][:restart]]):
            if p is None:
                p = providers[0]
                if i == len(feed):
                    p.reset()
            out = p(frame)
            outs.append(out)
            copies.append([t.clone() for t in tensors(out)])
            bands.append(p.last_band)
    names = collections.Counter(s.name for s in profiling.spans())
    profiling.clear()
    return outs, copies, bands, names


@pytest.mark.parametrize("batched", [False, True])
def test_graph_path_outputs_match_the_eager_step(est, stand_in, monkeypatch, batched):
    """Two providers on one estimator (six faces in one batched provider)
    through a pan that moves the band bucket and back, one restarted:
    outputs equal to the eager step's, none overwritten by a later call,
    one capture a part (the pair, the first frame of the restart, one
    check a bucket) and a replay for every other graphed part."""
    clips = [pan(10 + s) for s in range(2)]
    if batched:
        clips = [[torch.stack([clips[s % 2][t] for s in range(6)]).float() / 255.0
                  for t in range(len(STEPS))]]

        def make():
            return [provider_mod.BatchedStreamingFlowProvider(flow_estimator=est,
                                                              flow_scale=0.5)]
    else:
        def make():
            return [provider_mod.StreamingFlowProvider(flow_estimator=est, flow_scale=0.5,
                                                       erode_window=7) for _ in clips]
    eager, _, eager_bands, eager_names = run(make, clips)
    assert eager_names["flow.replay"] == 0 and est not in step_graphs._SHARED
    monkeypatch.setattr(provider_mod._Streaming, "_graphs", stand_in)
    buckets = []
    band = provider_mod._Streaming._band
    monkeypatch.setattr(provider_mod._Streaming, "_band",
                        lambda self, flows: buckets.append(band(self, flows)) or buckets[-1])
    outs, copies, bands, names = run(make, clips)
    assert bands == eager_bands
    assert len({b for b in bands if b is not None}) >= 2
    for a, b, c in zip(eager, outs, copies):
        assert len(tensors(a)) == len(tensors(b)) == len(c)
        for x, y, z in zip(tensors(a), tensors(b), c):
            assert torch.equal(x, y) and torch.equal(y, z)
    n = len(clips)
    # the first frame and first pair of each provider are eager; the rest,
    # and the restarted provider's first frame and pair, replay
    pairs = n * (len(clips[0]) - 2) + 1
    graphed_buckets = buckets[n:]
    assert len(graphed_buckets) == pairs
    captures = 2 + len(set(graphed_buckets))
    assert names["flow.capture"] == captures
    assert names["flow.capture"] + names["flow.replay"] == 2 * pairs + 1
    assert names["flow"] == len(outs)
    # the graphs live while a provider holds them (the stand-in's captured
    # function makes a cycle, so the collector frees them here)
    gc.collect()
    assert len(step_graphs._SHARED[est]) == 0


def test_kernel_entries_break_the_graph_and_replay_through_their_module(monkeypatch):
    """A ``graph_break`` entry (K1's) called while a step is captured
    goes to the capture's handler, and as itself outside one; a part's
    launch between two graphs calls the entry again by its module's
    attribute (where a wrapper sees it) and writes what it returns into
    the tensor the capture returned, which the graph after it reads."""
    from fast_artistic_videos_tpu_torch.ops import _build, warp_kernel

    assert warp_kernel.warp_banded.__wrapped__
    mod = types.ModuleType("graph_break_probe")
    calls = []

    @_build.graph_break
    def entry(x, k=1):
        calls.append("entry")
        return x * k

    mod.entry = entry
    entry.__module__ = mod.__name__
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    x = torch.arange(4.0)
    assert torch.equal(entry(x, k=2), 2 * x)
    taken = []

    def handler(fn, args, kwargs):
        taken.append((fn.__name__, args, kwargs))
        with _build.capturing(None):
            assert torch.equal(entry(*args, **kwargs), 3 * x)
        return fn(*args, **kwargs)

    with _build.capturing(handler):
        out = entry(x, k=3)
    assert taken == [("entry", (x,), {"k": 3})] and calls == ["entry"] * 3
    assert getattr(_build._GRAPH, "handler", None) is None
    launch = step_graphs._Launch(mod.__name__, "entry", (x,), {"k": 3}, out)
    wrapped = []
    monkeypatch.setattr(mod, "entry", lambda *a, **k: wrapped.append(1) or entry(*a, **k))
    x.add_(1.0)
    launch()
    assert wrapped == [1] and torch.equal(out, 3 * x)


def test_the_estimators_table_holds_graphs_while_a_provider_does():
    """``shared`` gives providers on one estimator one StepGraphs a key,
    and the table lets it go once no provider holds it."""
    owner = type("Estimator", (), {})()
    a = step_graphs.shared(owner, ("k", 1), torch.device("cpu"))
    assert step_graphs.shared(owner, ("k", 1), torch.device("cpu")) is a
    assert step_graphs.shared(owner, ("k", 2), torch.device("cpu")) is not a
    assert list(step_graphs._SHARED[owner]) == [("k", 1)]
    del a
    assert len(step_graphs._SHARED[owner]) == 0
