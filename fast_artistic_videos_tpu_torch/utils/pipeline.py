"""Host-side async pipelining for the frame loop.

The PyTorch port's own copy of ``fast_artistic_videos_tpu/utils/pipeline.py`` (numpy and the standard
library only, and the port's spans): the port imports nothing of the JAX package.

The reference synchronizes with the concurrently-running flow producer by
polling the filesystem at 1 Hz with an extra safety sleep
(utils.lua:74-80). Here that becomes an explicit producer/consumer:

  * :func:`wait_for_file` — kept for CLI-level parity with the script
    pipeline (a flow producer may still be an external process), but with a
    completeness check (netpbm/flo files declare their payload size) instead
    of the blind 1-second sleep.
  * :class:`Prefetcher` — background thread that loads frame i+1's inputs
    (frame, flow, certainty) from disk while the device stylizes frame i.
  * :class:`AsyncWriter` — background thread for PNG encoding/writes.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import queue
import threading
import time
from typing import Callable, Iterator, Optional

from . import profiling


def file_complete(path: str) -> bool:
    """Best-effort completeness check for .flo / netpbm files."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return False
    if size == 0:
        return False
    ext = os.path.splitext(path)[1].lower()
    try:
        if ext == ".flo":
            import struct

            with open(path, "rb") as f:
                header = f.read(12)
            if len(header) < 12:
                return False
            _, w, h = struct.unpack("<fii", header)
            return size >= 12 + 8 * w * h
        if ext in (".pgm", ".ppm"):
            from ..core import io as _io

            h, w = _io.image_size(path)
            channels = 3 if ext == ".ppm" else 1
            return size >= h * w * channels  # payload at least present
    except Exception:
        return False
    return True


def wait_for_file(path: str, poll_seconds: float = 0.1, timeout: Optional[float] = None) -> bool:
    """Block until *path* exists and looks complete. Returns False on timeout."""
    start = time.monotonic()
    announced = False
    while not (os.path.exists(path) and file_complete(path)):
        if timeout is not None and time.monotonic() - start > timeout:
            return False
        if not announced:
            announced = True
        time.sleep(poll_seconds)
    return True


class Prefetcher:
    """Wrap a (blocking) per-index loader into a lookahead thread.

    With `stream` given, the consumer's wait for index i is a span keyed
    ``(stream, i)``; without it the wait carries the caller's key."""

    _SENTINEL = object()

    def __init__(self, load: Callable[[int], object], indices, depth: int = 2,
                 stream: Optional[int] = None):
        self._load = load
        self._indices = list(indices)
        self._stream = stream
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._run, args=(self._indices,), daemon=True)
        self._thread.start()

    def _run(self, indices):
        try:
            for i in indices:
                item = self._load(i)
                self._q.put((i, item))
                if item is None:
                    return
        except Exception as e:  # surface in consumer
            self._q.put((None, e))
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self) -> Iterator:
        for n in itertools.count():
            keyed = (profiling.keyed(self._stream, self._indices[n])
                     if self._stream is not None and n < len(self._indices)
                     else contextlib.nullcontext())
            with keyed, profiling.span("pipeline.prefetch_wait"):
                got = self._q.get()
            if got is self._SENTINEL:
                return
            i, item = got
            if isinstance(item, Exception):
                raise item
            if item is None:
                return
            yield i, item


class AsyncWriter:
    """Serial background writer; call .put(fn) with a no-arg callable."""

    def __init__(self, depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[Exception] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            fn = self._q.get()
            if fn is None:
                return
            try:
                fn()
            except Exception as e:
                self._err = e

    def put(self, fn: Callable[[], None]) -> None:
        if self._err:
            raise self._err
        with profiling.span("pipeline.writer_wait"):
            self._q.put(fn)

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        # surface an error from the FINAL writes too (put() only re-raises
        # on the next call, which never comes for the last frame)
        if self._err:
            raise self._err
