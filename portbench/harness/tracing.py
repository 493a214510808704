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

from . import spec, work

WINDOW = "portbench.window"
FLOW, STYLIZER, POOL = "flow", "stylizer", "pool.process"
SPANS = (FLOW, STYLIZER, POOL)

def symbol_group(kernel_name: str, symbols):
    """The group (a file of ``portbench/kernels/``) whose symbol
    (``{group: SYMBOL}``) the device kernel's name carries, or None."""
    for g, sym in symbols.items():
        if sym in kernel_name:
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

def _owner(path: str):
    """A module, or a class of one, by its dotted path."""
    try:
        return importlib.import_module(path)
    except ModuleNotFoundError:
        mod, _, attr = path.rpartition(".")
        return getattr(importlib.import_module(mod), attr)


def _on_card(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


class Launches:
    """While ``recording()``: each launch on a card through the program's
    Python entries that a file of ``portbench/kernels/`` names, as (its
    group, least seconds). A group's file gives ``SYMBOL`` (what its device
    code's name carries) and ``ENTRIES``: (owner's dotted path, attribute,
    count), where ``count(vr, *args, **kwargs)`` of a call's arguments is
    the launch's (flops, bytes, dtype), or None where the launch is another
    group's. ``vr`` is the cell's face geometry (face and per-map strip
    areas; None in 2D), from which K5's launches are counted."""

    def __init__(self, vr=None, bench_dir=None):
        self.items = []
        self._lock = threading.Lock()
        self.vr = vr
        self.kernels = spec.kernels(bench_dir or spec.BENCH_DIR)
        self.symbols = {g: mod.SYMBOL for g, mod in self.kernels.items()}

    def _add(self, group, flops, nbytes, dtype):
        with self._lock:
            self.items.append((group, work.least_seconds(nbytes, flops, dtype)))

    def by_group(self):
        out = defaultdict(lambda: [0, 0.0])
        for g, s in self.items:
            out[g][0] += 1
            out[g][1] += s
        return dict(out)

    def _wrap(self, fn, counts):
        def wrapped(*args, **kwargs):
            if _on_card(args):
                for group, count in counts:
                    got = count(self.vr, *args, **kwargs)
                    if got is not None:
                        self._add(group, *got)
            return fn(*args, **kwargs)
        return wrapped

    @contextlib.contextmanager
    def recording(self):
        entries = defaultdict(list)
        for group, mod in self.kernels.items():
            for owner, attr, count in mod.ENTRIES:
                entries[(owner, attr)].append((group, count))
        saved = []
        try:
            for (path, attr), counts in entries.items():
                owner = _owner(path)
                fn = getattr(owner, attr, None)
                if fn is None:
                    print(f"portbench: {path}.{attr} not found; its launches "
                          f"are not counted", file=sys.stderr)
                    continue
                saved.append((owner, attr, fn))
                setattr(owner, attr, self._wrap(fn, counts))
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

    def __init__(self, bounds, busy_s, events, spans, launches, idle_gaps, stats, symbols):
        self.bounds = bounds           # (start_ns, end_ns) of the window
        self.window_s = (bounds[1] - bounds[0]) / 1e9
        self.busy_s = busy_s           # {card: seconds with an operation running}
        self.events = events           # [(name, card, start_ns, end_ns, span or None)]
        self.spans = spans             # {name: [(tid, start_ns, end_ns)]}
        self.launches = launches       # {symbol group: [launches, least seconds]}
        self.idle_gaps = idle_gaps     # [(what the host did, seconds)]
        self.stats = stats             # how the attribution went, for stderr
        self.symbols = symbols         # {kernel group: the symbol its device code carries}


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
                 named, dict(stats), launches.symbols)


def device_ops(trace: Trace, top: int = 10):
    """The device operations that took most time in the window."""
    w0, w1 = trace.bounds
    tot = defaultdict(int)
    for n, _, a, b, _ in trace.events:
        if b > w0 and a < w1:
            tot[n[:120]] += min(b, w1) - max(a, w0)
    return [[n, d / 1e9] for n, d in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def roofline(trace: Trace, groups):
    """The least time of the work of the kernel groups' launches over their
    device time in the traced window, in %. Records are matched to launches
    by the symbol their device code carries; where the profiler kept more
    or fewer records of a group than launches were made, that group's least
    time is scaled by the records it kept. None without a launch of any of
    `groups`."""
    w0, w1 = trace.bounds
    device_ns, records = {}, {}
    for name, _, a, b, _ in trace.events:
        g = symbol_group(name, trace.symbols)
        if g is None or not (w0 <= a < w1):
            continue
        device_ns[g] = device_ns.get(g, 0) + (b - a)
        records[g] = records.get(g, 0) + 1
    least = busy = 0.0
    for g, (launches, seconds) in trace.launches.items():
        if g not in groups or g not in device_ns or not launches:
            continue
        least += seconds * records[g] / launches
        busy += device_ns[g] / 1e9
    if busy <= 0.0:
        return None
    return 100.0 * least / busy
