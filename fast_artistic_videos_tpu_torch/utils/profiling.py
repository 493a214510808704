"""The port's tracing: spans at the boundaries of its layers, on the clock
of torch.profiler's host events.

A span (``with span(name):``, or ``@traced(name)`` on a function) records
its name, its own id, the id of the span open around it on the same thread,
the request key, the thread and its start and end in ns. The request key is
``(stream, frame)``: the layer that knows it (a driver's loop, the serving
pool) sets it with ``keyed(stream, frame)``, and every span opened inside on
the same thread carries it. Start and end are ``time.time_ns()``, the clock
that torch.profiler reports its events' ``start_ns()`` on, so a span lines
up with the device trace of the same run.

Spans record only while a torch.profiler run is active (on any thread) or
inside ``recording()``. Under the profiler each span also opens a host
range of its name (a ``cpu_op`` event), so it shows in the profile and in
any Chrome trace exported from it. The range is not a ``record_function``
user annotation: the profiler copies those onto the card's timeline as
ranges over the kernels launched inside them, which a reader of the device
trace would take for device work. With neither, ``span`` and ``keyed``
make one check and return a shared no-op context: they allocate nothing
and open no range.

Finished spans are kept in memory, in a buffer of the last ``MAX_SPANS``
(older ones are dropped and counted by ``dropped()``); nothing is written
to disk. ``spans(start_ns, end_ns)`` reads those wholly inside an interval,
``self_ns`` the self time of some of them.

The spans, by layer: ``pipeline.prefetch_wait`` and
``pipeline.writer_wait`` (the drivers' loops, ``utils.pipeline``),
``pool.process`` and ``pool.upload`` (``video.serving``), ``flow`` and
``flow.band_wait`` (``flow.provider``), ``flow.capture`` and
``flow.replay`` inside ``flow`` (the capture and the replay of a part
of the step as CUDA graphs, ``flow.graphs``, on a card only), ``flow.fn2.c``,
``.s1``, ``.s2``, ``.sd`` and ``.fusion`` (FlowNet 2.0's networks, where
they run outside a graph), ``engine.step`` (``video.engine``'s public
steps), ``stylizer`` (the stylizer's forward), ``vr.prior``, ``vr.blend``
and ``vr.outputs`` (``video.driver_vr``), and ``kernel.K1`` to
``kernel.K7`` (each hand-written kernel's Python entry, on a card only).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from collections import deque
from typing import Iterable, List, NamedTuple, Optional, Tuple

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

# ten 20-s windows of the 360-degree clip: about 130 spans a frame of six
# 922-px faces at about 4 frames a second
MAX_SPANS = 1 << 17


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]           # the id of the span open around it, same thread
    key: Optional[Tuple[int, int]]  # (stream, frame)
    thread: int                     # threading.get_ident()
    start_ns: int                   # time.time_ns()
    end_ns: int


def _profiler_on() -> bool:
    # set by every torch.profiler run for all threads; the C flag
    # (torch.autograd._profiler_enabled) is per thread, and off on every
    # thread under profile_all_threads
    return _autograd_profiler._is_profiler_enabled

_NOOP = contextlib.nullcontext()
_LOCAL = threading.local()           # .stack: open span ids; .key: the request key
_IDS = itertools.count(1)
_LOCK = threading.Lock()
_BUFFER: deque = deque(maxlen=MAX_SPANS)
_state = {"recording": 0, "dropped": 0}


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


def _add(s: Span) -> None:
    with _LOCK:
        if len(_BUFFER) == _BUFFER.maxlen:
            _state["dropped"] += 1
        _BUFFER.append(s)


class _Open:
    """One open span."""

    __slots__ = ("name", "id", "parent", "key", "start", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _stack()
        self.parent = st[-1] if st else None
        self.id = next(_IDS)
        st.append(self.id)
        self.key = getattr(_LOCAL, "key", None)
        self.start = time.time_ns()
        self._range = None
        if _profiler_on():
            self._range = _RecordFunctionFast(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        end = time.time_ns()
        _stack().pop()
        _add(Span(self.name, self.id, self.parent, self.key, threading.get_ident(),
                  self.start, end))
        return False


def span(name: str):
    """A context manager recording a span named `name` while tracing is on;
    a shared no-op otherwise."""
    if not (_state["recording"] or _profiler_on()):
        return _NOOP
    return _Open(name)


def traced(name: str):
    """Decorator: each call of the function is a span named `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class _Keyed:
    __slots__ = ("key", "_saved")

    def __init__(self, key):
        self.key = key

    def __enter__(self):
        self._saved = getattr(_LOCAL, "key", None)
        _LOCAL.key = self.key

    def __exit__(self, *exc):
        _LOCAL.key = self._saved
        return False


def keyed(stream: int, frame: int):
    """A context manager setting the request key ``(stream, frame)`` of the
    spans opened inside it on this thread, while tracing is on."""
    if not (_state["recording"] or _profiler_on()):
        return _NOOP
    return _Keyed((stream, frame))


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler."""
    with _LOCK:
        _state["recording"] += 1
    try:
        yield
    finally:
        with _LOCK:
            _state["recording"] -= 1


def spans(start_ns: Optional[int] = None, end_ns: Optional[int] = None) -> List[Span]:
    """The recorded spans wholly inside [start_ns, end_ns] (either bound may
    be None), in the order they ended."""
    with _LOCK:
        got = list(_BUFFER)
    return [s for s in got if (start_ns is None or s.start_ns >= start_ns)
            and (end_ns is None or s.end_ns <= end_ns)]


def dropped() -> int:
    """Spans dropped from the buffer since the last ``clear()``."""
    return _state["dropped"]


def clear() -> None:
    """Forget every recorded span and the count of dropped ones."""
    with _LOCK:
        _BUFFER.clear()
        _state["dropped"] = 0


def self_ns(among: Iterable[Span], names, less=()) -> int:
    """Summed over the spans of `among` named in `names`: each one's
    duration less the part of it that its descendants named in `less`
    cover (a descendant counts for the nearest ancestor named in
    `names`)."""
    among = list(among)
    by_id = {s.id: s for s in among}
    covered = {s.id: [] for s in among if s.name in names}
    for s in among:
        if s.name not in less:
            continue
        p = by_id.get(s.parent)
        while p is not None and p.id not in covered:
            p = by_id.get(p.parent)
        if p is not None:
            covered[p.id].append((max(s.start_ns, p.start_ns), min(s.end_ns, p.end_ns)))
    total = 0
    for sid, parts in covered.items():
        s = by_id[sid]
        total += s.end_ns - s.start_ns
        end = s.start_ns
        for a, b in sorted(parts):
            a = max(a, end)
            if b > a:
                total -= b - a
                end = b
    return total
