"""The streaming flow providers' per-step device work as CUDA graphs.

A provider's step on a card launches thousands of small kernels (the cost
volume's shifts, the consistency check's filter taps), so the host takes
longer to issue it than the card takes to run it. Its work splits at the
one host read of a step, the band: the features of the new frame and both
flows of the pair need no band; the consistency check does. Each part is
captured once and replayed after that, under a key of everything the
captured work depends on: the card, the frames' shape and dtype, the flow
scale and the provider's fixed settings (the provider's key), and for the
check the band.

A part is CUDA graphs with the hand-written kernels' launches between
them: a kernel's entry marked ``ops._build.graph_break`` (K1's) ends the
graph before its launch, which runs eagerly, and the next graph starts
after it. At each replay the part replays its graphs and calls those
entries again on the graphs' tensors, so every launch of a hand-written
kernel is a call of its entry: its counters and spans, and whatever wraps
the entry, see it as they see an eager one. About 7 such launches a
1080p pair, 12 a step of six faces.

Providers built on one estimator share its graphs (:func:`shared`): one
:class:`StepGraphs` a key for as long as a provider holds it; the
estimator's table holds them weakly, so a key no provider uses any more
frees its graphs. A provider's frames and previous features are copied
into the key's static inputs, the graphs read those and write static
outputs, and the provider copies what it keeps out into tensors of its
own, so that nothing it returns is overwritten by a later replay, its own
or another provider's.

The captures run on a side stream of their own in ``thread_local`` mode,
so another thread may launch, wait for its own stream and copy to the
host meanwhile (the 2D driver's loop thread does, while its prefetch
thread runs the flow); a device-wide ``torch.cuda.synchronize()`` during
a capture is an error of CUDA's, whatever the thread. Captures take turns
in the process, and a key's first capture returns the blocks the
allocator keeps cached to the card (the eager first steps' working set),
so that the pool's own take their place. A capture runs each
graph as soon as it is captured (the launch after it reads what it
computed), so it returns the part's outputs as a replay does. A capture
is the span ``flow.capture``, a replay the span ``flow.replay``.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import weakref
from typing import Callable, Dict, NamedTuple

import torch
from torch.utils import _pytree

from ..ops import _build
from ..utils import profiling

_LOCK = threading.Lock()
# one capture at a time in the process (see StepGraphs._capture)
_CAPTURING = threading.Lock()
# estimator -> {provider's key: StepGraphs}, both held weakly
_SHARED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def shared(owner, key, device: torch.device) -> "StepGraphs":
    """The graphs of `key` among those of `owner` (an estimator) on
    `device`, made empty where no provider holds them; the caller keeps a
    reference for as long as it uses them."""
    with _LOCK:
        per_key = _SHARED.get(owner)
        if per_key is None:
            per_key = _SHARED[owner] = weakref.WeakValueDictionary()
        graphs = per_key.get(key)
        if graphs is None:
            graphs = per_key[key] = StepGraphs(device)
        return graphs


class _Launch(NamedTuple):
    """A hand-written kernel's launch between two graphs of a part: its
    entry by module and name, the arguments it took at the capture (the
    graphs' tensors) and what it returned there, which the graph after it
    reads."""

    module: str
    name: str
    args: tuple
    kwargs: dict
    out: torch.Tensor

    def __call__(self):
        got = getattr(sys.modules[self.module], self.name)(*self.args, **self.kwargs)
        if got is not self.out:
            self.out.copy_(got)


class _Part(NamedTuple):
    steps: tuple               # graphs' replays and _Launch-es, in order
    outputs: object            # what the captured function returned: the static outputs


class StepGraphs:
    """The graphs of one key: static inputs (``frames``, ``prev``), the
    captured parts by name, one memory pool that they share, and a lock.
    Use them inside :meth:`use` (the lock, and the order on the card after
    the last use): :meth:`load` the inputs, :meth:`run` each part, and copy
    out what is kept before the block ends."""

    def __init__(self, device: torch.device):
        self.device = device
        self.frames = None
        self.prev = None
        self._lock = threading.Lock()
        self._parts: Dict[object, _Part] = {}
        self._pool = None
        self._stream = None
        self._done = None
        self._last_stream = None

    def has(self, name) -> bool:
        return name in self._parts

    @contextlib.contextmanager
    def use(self):
        """Hold the graphs for one step: their static buffers are shared, so
        a step that reads them runs on the card after the last step that
        wrote them, on whichever stream either ran."""
        with self._lock, torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device)
            if self._done is not None and stream != self._last_stream:
                stream.wait_event(self._done)
            try:
                yield self
            finally:
                if self._done is None:
                    self._done = torch.cuda.Event()
                self._done.record(stream)
                self._last_stream = stream

    def load(self, frames, prev=None) -> None:
        """Copy `frames` and `prev` (a tensor or a tuple of them) into the
        static inputs, made at the first call."""
        if self.frames is None:
            self.frames = torch.empty(frames.shape, dtype=frames.dtype, device=self.device)
        self.frames.copy_(frames)
        if prev is not None:
            leaves, tree = _pytree.tree_flatten(prev)
            if self.prev is None:
                self.prev = _pytree.tree_unflatten(
                    [torch.empty_like(t) for t in leaves], tree)
            for dst, src in zip(_pytree.tree_leaves(self.prev), leaves):
                dst.copy_(src)

    def run(self, name, fn: Callable):
        """Replay part `name`, capturing ``fn()`` as it at the first call;
        returns the part's static outputs (what ``fn`` returned)."""
        part = self._parts.get(name)
        if part is None:
            with profiling.span("flow.capture"), _CAPTURING:
                part = self._parts[name] = self._capture(fn)
            return part.outputs
        with profiling.span("flow.replay"):
            for step in part.steps:
                step()
        return part.outputs

    def _capture(self, fn: Callable) -> _Part:
        if self._pool is None:
            # the blocks the key's eager first steps left cached go back to
            # the card before the pool takes its own; a device-wide
            # synchronisation, so no other capture may be under way
            torch.cuda.empty_cache()
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        caller = torch.cuda.current_stream(self.device)
        steps = []
        graph = None

        def begin():
            nonlocal graph
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")

        def end():
            graph.capture_end()
            steps.append(graph.replay)
            with torch.cuda.stream(caller):
                graph.replay()

        def launch(entry, args, kwargs):
            end()
            with torch.cuda.stream(caller), _build.capturing(None):
                out = entry(*args, **kwargs)
            steps.append(_Launch(entry.__module__, entry.__name__, args, kwargs, out))
            begin()
            return out

        with torch.cuda.stream(self._stream), _build.capturing(launch):
            begin()
            try:
                outputs = fn()
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            end()
        return _Part(tuple(steps), outputs)


def clone(tree):
    """A copy of a tensor or a tuple of them, in tensors of the caller's."""
    return _pytree.tree_map(torch.Tensor.clone, tree)
