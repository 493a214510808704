"""The traced run: spans from the benchmark's own wrappers, the record of
each hand-written kernel's launches with its work, and the reading of
torch.profiler's trace into what the per-layer readers take.

Spans are ``torch.profiler.record_function`` ranges around the calls into
each layer (the flow provider, the stylizer's forward, the pool's
``process``). A kernel's device time goes to the innermost span that was
open on the thread that launched it, when it was launched.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import sys
import threading
from collections import defaultdict

import torch

from . import work

WINDOW = "portbench.window"
FLOW, STYLIZER, POOL = "flow", "stylizer", "pool.process"
SPANS = (FLOW, STYLIZER, POOL)

# the hand-written kernels by the symbol their device code carries; K2 and
# K4 share theirs
SYMBOL_GROUPS = ("warp_banded", "conv3x3_f32", "front_f32", "conv_tc", "front_tc",
                 "conv_in_kernel", "strip_warp")


def symbol_group(kernel_name: str):
    for g in SYMBOL_GROUPS:
        if g in kernel_name:
            return g
    return None


def all_threads():
    """The profiler's option to record every thread's ops and spans (the
    drivers' prefetch and writer threads), where this torch has it."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        print("portbench: this torch's profiler records the main thread only",
              file=sys.stderr)
        return None


def spanned(fn, name):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


class SpannedProvider:
    """A flow provider whose calls are spans; every other attribute
    (``last_band``, ``erode_window``, ``reset``) is the provider's."""

    def __init__(self, provider, name=FLOW):
        self._provider = provider
        self._call = spanned(provider.__call__, name)

    def __call__(self, *args, **kwargs):
        return self._call(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._provider, name)


# ---------------------------------------------------------------------------
# kernel launches with their work
# ---------------------------------------------------------------------------

def _isz(t):
    return t.element_size()


def _dname(t):
    return "bfloat16" if t.dtype == torch.bfloat16 else "float32"


def _group(kernel: str, dtype: str) -> str:
    if kernel == "K1":
        return "warp_banded"
    if kernel == "K5":
        return "strip_warp"
    if kernel == "K3":
        return "front_tc" if dtype == "bfloat16" else "front_f32"
    return "conv_tc" if dtype == "bfloat16" else "conv3x3_f32"


class Launches:
    """While ``recording()``: each launch of K1-K5 on a card through the
    program's Python entries, as (symbol group, least seconds). The K5
    entries are counted from the geometry the cell states (``vr``: face
    and per-map strip areas)."""

    def __init__(self, vr=None):
        self.items = []
        self._lock = threading.Lock()
        self.vr = vr

    def _add(self, kernel, dtype, flops, nbytes):
        with self._lock:
            self.items.append((_group(kernel, dtype), work.least_seconds(nbytes, flops, dtype)))

    def by_group(self):
        out = defaultdict(lambda: [0, 0.0])
        for g, s in self.items:
            out[g][0] += 1
            out[g][1] += s
        return dict(out)

    def _entries(self):
        """(module, attribute, wrapper factory) of every entry recorded."""
        def warp(fn):
            def w(img, flow, band):
                if img.is_cuda:
                    self._add("K1", _dname(img), *work.warp_work(tuple(img.shape), _isz(img)))
                return fn(img, flow, band)
            return w

        def chain(fn):
            def w(x, wt, b, eff=None, pre_relu=False, skip=None, emit_input=False):
                if x.is_cuda:
                    h, wd, _ = x.shape
                    self._add("K2", _dname(x), *work.conv_work(
                        (1,) + tuple(x.shape), tuple(wt.shape), (h - 2, wd - 2), _isz(x),
                        eff=eff is not None, skip=skip is not None, emit=emit_input))
                return fn(x, wt, b, eff=eff, pre_relu=pre_relu, skip=skip,
                          emit_input=emit_input)
            return w

        def front(fn):
            def w(x, wt, b, stride, pad, eff=None, relu=False):
                if x.is_cuda:
                    h, wd, _ = x.shape
                    k = wt.shape[2]
                    ho, wo = (h + 2 * pad - k) // stride + 1, (wd + 2 * pad - k) // stride + 1
                    self._add("K3", _dname(x), *work.conv_work(
                        (1,) + tuple(x.shape), tuple(wt.shape), (ho, wo), _isz(x),
                        eff=eff is not None))
                return fn(x, wt, b, stride, pad, eff=eff, relu=relu)
            return w

        def block(pad):
            def make(fn):
                def w(x, wt, b, relu=False):
                    if x.is_cuda:
                        n, h, wd, _ = x.shape
                        self._add("K4", _dname(x), *work.conv_work(
                            tuple(x.shape), tuple(wt.shape), (h + 2 * pad - 2, wd + 2 * pad - 2),
                            _isz(x), stats=False))
                    return fn(x, wt, b, relu=relu)
                return w
            return make

        out = [("fast_artistic_videos_tpu_torch.ops.warp_kernel", "warp_banded", warp),
               ("fast_artistic_videos_tpu_torch.ops.rblock_kernel", "chain_conv", chain),
               ("fast_artistic_videos_tpu_torch.ops.front_kernel", "same_conv", front),
               ("fast_artistic_videos_tpu_torch.ops.conv_kernel", "conv3x3", block(1)),
               ("fast_artistic_videos_tpu_torch.ops.conv_kernel", "conv3x3_valid", block(0))]
        if self.vr is not None:
            out += self._strip_entries()
        return out

    def _strip_entries(self):
        from ..reference import video as vref

        face, areas = self.vr

        def prior(fn):
            def w(obj, pos, segments, div):
                if div.is_cuda:
                    self._add("K5", "float32", *work.strip_prior_work(
                        face, areas, vref.PRIOR_TERMS[pos], pos in (4, 5)))
                return fn(obj, pos, segments, div)
            return w

        def blend(fn):
            def w(obj, segments, gm, div):
                if div.is_cuda:
                    self._add("K5", "float32", *work.strip_blend_work(
                        face, areas, vref.BLEND_TERMS))
                return fn(obj, segments, gm, div)
            return w

        mod = importlib.import_module("fast_artistic_videos_tpu_torch.ops.strip_warp_kernel")
        return [(mod.StripSet, "prior", prior), (mod.StripSet, "blend", blend)]

    @contextlib.contextmanager
    def recording(self):
        saved = []
        try:
            for owner, attr, make in self._entries():
                if isinstance(owner, str):
                    owner = importlib.import_module(owner)
                fn = getattr(owner, attr, None)
                if fn is None:
                    print(f"portbench: {owner.__name__}.{attr} not found; its launches "
                          f"are not counted", file=sys.stderr)
                    continue
                saved.append((owner, attr, fn))
                setattr(owner, attr, make(fn))
            yield self
        finally:
            for owner, attr, fn in saved:
                setattr(owner, attr, fn)


# ---------------------------------------------------------------------------
# reading the trace
# ---------------------------------------------------------------------------

class Trace:
    """What the per-layer readers take from one profiled window: the
    window's length, each card's device intervals, each device event
    (name, card, start, end, span), the spans by name and the kernels'
    launch record."""

    def __init__(self, bounds, busy_s, events, spans, launches, idle_gaps, stats):
        self.bounds = bounds           # (start_ns, end_ns) of the window
        self.window_s = (bounds[1] - bounds[0]) / 1e9
        self.busy_s = busy_s           # {card: seconds with an operation running}
        self.events = events           # [(name, card, start_ns, end_ns, span or None)]
        self.spans = spans             # {name: [(tid, start_ns, end_ns)]}
        self.launches = launches       # {symbol group: [launches, least seconds]}
        self.idle_gaps = idle_gaps     # [(what the host did, seconds)]
        self.stats = stats             # how the attribution went, for stderr


def _call(ev, name, default=None):
    fn = getattr(ev, name, None)
    if fn is None:
        return default
    try:
        return fn()
    except (RuntimeError, TypeError):
        return default


def _union(intervals, lo, hi):
    busy, end = 0, lo
    merged = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    for a, b in merged:
        busy += b - a
    return busy, merged


class _SpanIndex:
    def __init__(self, spans):
        self.by_tid = defaultdict(list)
        for name, tid, a, b in spans:
            self.by_tid[tid].append((a, b, name))
        for v in self.by_tid.values():
            v.sort()
        self.starts = {tid: [s[0] for s in v] for tid, v in self.by_tid.items()}

    def innermost(self, tid, t):
        v = self.by_tid.get(tid)
        if not v:
            return None
        i = bisect.bisect_right(self.starts[tid], t)
        best = None
        for a, b, name in reversed(v[max(0, i - 64):i]):
            if a <= t <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        return best[2] if best else None


def read(prof, launches: Launches, cards: int) -> Trace:
    """The window, device intervals by card, device events with their
    spans, and the idle gaps of card 0, from a finished profile."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    cpu, dev, spans, window = [], [], [], None
    for ev in raw:
        name = ev.name()
        dtype = ev.device_type()
        if dtype == DeviceType.CPU:
            a, b = ev.start_ns(), ev.end_ns()
            tid = ev.start_thread_id()
            if name == WINDOW:
                window = (a, b, tid)
            elif name in SPANS:
                spans.append((name, tid, a, b))
            cpu.append((ev.correlation_id(), tid, a, b, name,
                        _call(ev, "linked_correlation_id", 0)))
        elif dtype == DeviceType.CUDA and name not in SPANS and name != WINDOW \
                and "annotation" not in str(_call(ev, "activity_type", "")):
            # the spans' device-side copies are ranges, not operations
            dev.append((name, ev.device_index(), ev.start_ns(), ev.end_ns(),
                        ev.correlation_id(), _call(ev, "linked_correlation_id", 0)))
    if window is None:
        raise RuntimeError("the profile holds no window span")
    if not dev:
        raise RuntimeError("torch.profiler recorded no operation on the card")
    w0, w1, main_tid = window
    index = _SpanIndex(spans)
    # CUDA runtime calls and torch's own ops number their correlations
    # apart: a kernel names its launch call, and through the linked id the
    # op that launched it
    launch_map, op_map = {}, {}
    for corr, tid, a, b, name, _ in cpu:
        if corr:
            (launch_map if name.startswith("cu") else op_map).setdefault(corr, (tid, a))
    stats = defaultdict(int)
    events = []
    for name, card, a, b, corr, linked in dev:
        span = None
        launch = launch_map.get(corr)
        if launch is not None and launch[0] in index.by_tid:
            span = index.innermost(*launch)
            stats["by launch"] += 1
        elif linked and linked in op_map:
            span = index.innermost(*op_map[linked])
            stats["by linked op"] += 1
        else:
            stats["unlinked"] += 1
        events.append((name, card, a, b, span))
    busy, gaps = {}, []
    for c in range(cards):
        s, merged = _union([(a, b) for _, card, a, b, _ in events if card == c], w0, w1)
        busy[c] = s / 1e9
        if c == 0:
            prev = w0
            for a, b in merged + [[w1, w1]]:
                if a > prev:
                    gaps.append((prev, a))
                prev = max(prev, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    cpu_sorted = sorted((a, b, name, tid) for _, tid, a, b, name, _ in cpu)
    for a, b in gaps[:10]:
        mid = (a + b) // 2
        host = [s for s in (index.innermost(tid, mid) for tid in index.by_tid) if s]
        inner = [(y - x, name) for x, y, name, tid in cpu_sorted[:bisect.bisect_right(
            cpu_sorted, (mid, float("inf")))][-2000:] if x <= mid <= y and tid == main_tid
            and name not in SPANS and name != WINDOW]
        op = min(inner)[1] if inner else "no host op"
        named.append((f"{'+'.join(sorted(set(host))) or 'no span'}: {op[:80]}", (b - a) / 1e9))
    span_map = defaultdict(list)
    for name, tid, a, b in spans:
        if a >= w0 and b <= w1:
            span_map[name].append((tid, a, b))
    return Trace((w0, w1), busy, events, dict(span_map), launches.by_group(),
                 named, dict(stats))


def device_ops(trace: Trace, top: int = 10):
    """The device operations that took most time in the window."""
    w0, w1 = trace.bounds
    tot = defaultdict(int)
    for n, _, a, b, _ in trace.events:
        if b > w0 and a < w1:
            tot[n[:120]] += min(b, w1) - max(a, w0)
    return [[n, d / 1e9] for n, d in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]
